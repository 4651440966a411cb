"""Training-path tests: losses vs torch oracle, freeze rules, train step,
orbax checkpoint roundtrip, dp+tp sharded step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from camouflaged_vlm_tpu.train import (
    bce_with_logits,
    balanced_bce_with_logits,
    soft_iou_loss,
    edge_dice_loss,
    segmentation_loss,
    make_optimizer,
    trainable_mask,
    cosine_epoch_schedule,
    make_train_step,
    create_train_state,
    TrainState,
)
from camouflaged_vlm_tpu.models import CascadeConfig, OVCOSCascade
from camouflaged_vlm_tpu.factory import make_bank_inputs, init_cascade_params


def test_bce_matches_torch(rng):
    logits = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    gt = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    got = float(bce_with_logits(jnp.asarray(logits), jnp.asarray(gt)))
    want = float(F.binary_cross_entropy_with_logits(torch.from_numpy(logits), torch.from_numpy(gt)))
    assert abs(got - want) < 1e-6


def test_bbce_matches_torch_reference_formula(rng):
    logits = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    gt = (rng.random((2, 8, 8, 1)) > 0.7).astype(np.float32)
    got = float(balanced_bce_with_logits(jnp.asarray(logits), jnp.asarray(gt)))
    lt, gtt = torch.from_numpy(logits), torch.from_numpy(gt)
    eps = 1e-10
    count_pos = gtt.sum() + eps
    count_neg = (1 - gtt).sum()
    ratio = count_neg / count_pos
    w_neg = count_pos / (count_pos + count_neg)
    want = float(w_neg * F.binary_cross_entropy_with_logits(lt, gtt, pos_weight=ratio))
    assert abs(got - want) < 1e-5


def test_iou_loss_matches_torch(rng):
    logits = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    gt = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    got = float(soft_iou_loss(jnp.asarray(logits), jnp.asarray(gt)))
    # torch oracle with NCHW reduction over (2,3) == our NHWC over (1,2)
    pred = torch.sigmoid(torch.from_numpy(logits.transpose(0, 3, 1, 2)))
    t = torch.from_numpy(gt.transpose(0, 3, 1, 2))
    inter = (pred * t).sum(dim=(2, 3))
    union = (pred + t).sum(dim=(2, 3)) - inter
    want = float((1 - inter / union).mean())
    assert abs(got - want) < 1e-6


def test_edge_dice_matches_reference_formula(rng):
    prob = rng.random((2, 8, 8, 1)).astype(np.float32)
    edge = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    got = float(edge_dice_loss(jnp.asarray(prob), jnp.asarray(edge)))
    p = torch.from_numpy(prob).reshape(2, -1)
    e = torch.from_numpy(edge).reshape(2, -1)
    num = (p * e).sum(dim=1) * 2 + 1
    den = (p.pow(2) + e.pow(2)).sum(dim=1) + 1
    want = float((1 - num / den).mean())
    assert abs(got - want) < 1e-6


def test_cosine_epoch_schedule_endpoints():
    sched = cosine_epoch_schedule(2e-4, total_epochs=20, steps_per_epoch=10, eta_min=1e-7)
    assert abs(float(sched(0)) - 2e-4) < 1e-9
    # within epoch 0 the lr is constant (per-epoch stepping)
    assert float(sched(0)) == float(sched(9))
    assert abs(float(sched(200)) - 1e-7) < 1e-10


@pytest.fixture(scope="module")
def tiny_train_setup(tiny_cascade_2class):
    # shared session fixture (conftest) — test_convert builds the same thing
    return tiny_cascade_2class


def test_trainable_mask_matches_reference_freeze_rule(tiny_train_setup):
    cfg, model, bank, params = tiny_train_setup
    labels = trainable_mask(params)
    flat = jax.tree_util.tree_flatten_with_path(labels)[0]
    by_path = {
        "/".join(str(getattr(k, "key", k)) for k in p): v for p, v in flat
    }
    # frozen: SAM ViT blocks, the whole CLIP tower
    assert by_path["params/image_encoder/block_0/attn/qkv/kernel"] == "freeze"
    assert by_path["params/clip_model/image_encoder/conv1/kernel"] == "freeze"
    assert by_path["params/clip_model/prompt_learner/ctx"] == "freeze"
    # trainable: EVP prompts, decoder, projections, no_mask_embed
    assert by_path["params/image_encoder/prompt_generator/shared_mlp/kernel"] == "train"
    assert by_path["params/mask_decoder/iou_token"] == "train"
    assert by_path["params/visual_proj_dense/kernel"] == "train"
    assert by_path["params/no_mask_embed"] == "train"
    # pe_layer's gaussian matrix is a torch BUFFER in the reference
    # (sam_maskdecoder_edge.py:85-88) — model.parameters() never exposes it
    # to the optimizer, so it can never train there
    assert by_path["params/pe_layer/positional_encoding_gaussian_matrix"] == "freeze"


def _make_batch(cfg, bank, rng, B=2):
    return {
        "inp": jnp.asarray(rng.standard_normal((B, cfg.inp_size, cfg.inp_size, 3)), jnp.float32),
        "gt": jnp.asarray((rng.random((B, cfg.inp_size, cfg.inp_size, 1)) > 0.5), jnp.float32),
        "clip_image": jnp.asarray(rng.standard_normal((B, cfg.clip_size, cfg.clip_size, 3)), jnp.float32),
        "clip_mask": jnp.full((B, cfg.clip_size, cfg.clip_size, 1), 1.923, jnp.float32),
        **bank,
    }


@pytest.mark.slow  # ~55s grad equality; the hoist is also pinned by test_grad_ab
def test_hoisted_text_features_grads_match_bank_path(tiny_train_setup, rng):
    """`batch["text_features"]` (cli/train's once-per-run text encode) must
    give the same LOSS and GRADIENTS as the in-step prompt-bank path — the
    text tower is frozen, so hoisting it is semantics-free
    (cascade.forward_with_text). Gradients are compared (not post-AdamW
    updates: Adam normalises by |g|, so fp32 reassociation noise between
    the two compiled programs would blow up to full-scale update diffs on
    near-zero-gradient entries)."""
    from camouflaged_vlm_tpu.train.train_step import (
        combine_params, partition_params,
    )
    from camouflaged_vlm_tpu.train.losses import segmentation_loss

    cfg, model, bank, params = tiny_train_setup
    batch = _make_batch(cfg, bank, rng)
    trainable, frozen = partition_params(params)

    text_features = model.encode_class_text_features(
        params, bank["prefix"], bank["suffix"], bank["eot_indices"],
        bank["bank_features"],
    )

    def loss_bank(t):
        masks, edges = model(
            combine_params(t, frozen), batch["inp"], batch["clip_image"],
            batch["clip_mask"], bank["prefix"], bank["suffix"],
            bank["eot_indices"], bank["bank_features"],
        )
        return segmentation_loss(masks, edges, batch["gt"], "iou")[0]

    def loss_hoist(t):
        masks, edges = model.forward_with_text(
            combine_params(t, frozen), batch["inp"], batch["clip_image"],
            batch["clip_mask"], text_features,
        )
        return segmentation_loss(masks, edges, batch["gt"], "iou")[0]

    l1, g1 = jax.jit(jax.value_and_grad(loss_bank))(trainable)
    l2, g2 = jax.jit(jax.value_and_grad(loss_hoist))(trainable)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)

    def cmp(a, b):
        a, b = np.asarray(a), np.asarray(b)
        # floor 1e-8 absorbs pure-noise leaves (e.g. the iou head's, whose
        # gradient only exists through weak decoder coupling and sits at
        # ~1e-9 — different compiled programs round it differently)
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(a).max() + 1e-8)

    jax.tree.map(cmp, g1, g2)


def test_train_step_updates_only_trainable(tiny_train_setup, rng):
    cfg, model, bank, params = tiny_train_setup
    tx = make_optimizer(params)
    state = create_train_state(params, tx)
    step = jax.jit(make_train_step(model, tx))
    batch = _make_batch(cfg, bank, rng)
    new_state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))

    def flat(t):
        return {
            "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]
        }

    before, after = flat(params), flat(new_state.params)
    frozen_key = "params/image_encoder/block_0/attn/qkv/kernel"
    clip_key = "params/clip_model/image_encoder/conv1/kernel"
    train_key = "params/mask_decoder/iou_token"
    np.testing.assert_array_equal(before[frozen_key], after[frozen_key])
    np.testing.assert_array_equal(before[clip_key], after[clip_key])
    assert np.abs(before[train_key] - after[train_key]).max() > 0

    # loss decreases over a few steps on a fixed batch
    losses = [float(metrics["loss"])]
    s = new_state
    for _ in range(3):
        s, m = step(s, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_orbax_checkpoint_roundtrip(tiny_train_setup, tmp_path):
    from camouflaged_vlm_tpu.io.checkpoint import save_checkpoint, restore_checkpoint

    cfg, model, bank, params = tiny_train_setup
    tx = make_optimizer(params)
    state = create_train_state(params, tx)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    restored = restore_checkpoint(path, state)
    for (pa, a), (pb, b) in zip(
        jax.tree_util.tree_flatten_with_path(state.params)[0],
        jax.tree_util.tree_flatten_with_path(restored.params)[0],
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))
    assert int(restored.step) == int(state.step)


def test_maple_train_step_updates_only_prompt_learner(tiny_train_setup, rng):
    """MaPLe prompt training (reference dassl trainer equivalent,
    cocotrainers/mapleAlphaCLIP.py:300-386): CE loss decreases and ONLY
    prompt-learner params move. Eight steps at base lr 2e-3 (two warmup
    steps at 1e-5, then the cosine): the loss falls on each init seed 0-4,
    where five steps at 1e-2 overshot on seeds 0 and 4."""
    from camouflaged_vlm_tpu.train import (
        MAPLE_TRAINABLE_SUBTREES,
        make_maple_optimizer,
        make_maple_train_step,
    )

    cfg, model, bank, params = tiny_train_setup
    tx = make_maple_optimizer(base_lr=2e-3, total_epochs=5, steps_per_epoch=2)
    state = create_train_state(params, tx, MAPLE_TRAINABLE_SUBTREES)

    step = jax.jit(make_maple_train_step(model.clip_forward, tx))
    B = 2
    batch = {
        "clip_image": jnp.asarray(
            rng.standard_normal((B, cfg.clip_size, cfg.clip_size, 3)), jnp.float32
        ),
        "clip_alpha": jnp.asarray(
            rng.standard_normal((B, cfg.clip_size, cfg.clip_size, 1)), jnp.float32
        ),
        "label_id": jnp.asarray([0, 1], jnp.int32),
        **bank,
    }
    new_state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))

    def flat(t):
        return {
            "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]
        }

    before, after = flat(params), flat(new_state.params)
    # frozen: CLIP towers, SAM encoder, the cascade decoder
    for k in (
        "params/clip_model/image_encoder/conv1/kernel",
        "params/image_encoder/block_0/attn/qkv/kernel",
        "params/mask_decoder/iou_token",
        "params/clip_model/logit_scale",
    ):
        np.testing.assert_array_equal(before[k], after[k])
    # trainable: prompt learner ctx + projections
    assert np.abs(before["params/clip_model/prompt_learner/ctx"]
                  - after["params/clip_model/prompt_learner/ctx"]).max() > 0
    assert np.abs(before["params/clip_model/prompt_learner/proj/kernel"]
                  - after["params/clip_model/prompt_learner/proj/kernel"]).max() > 0

    losses = [float(metrics["loss"])]
    s = new_state
    for _ in range(7):
        s, m = step(s, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


@pytest.mark.slow  # ~1 min equality (dp-mesh variant below is slow too)
def test_grad_accum_matches_full_batch(tiny_train_setup, rng):
    """accum_steps=2 over a batch of 4 must produce the same update as one
    full-batch step: iou/bce losses are per-image means, so the microbatch
    gradient average equals the full-batch gradient exactly (up to
    reduction-order rounding). SGD isolates the accumulation math — Adam's
    g/sqrt(v) normalisation amplifies rounding-level gradient differences
    on near-zero-gradient params to O(lr), which is an optimizer property,
    not an accumulation bug."""
    import optax

    cfg, model, bank, params = tiny_train_setup
    tx = optax.sgd(0.1)
    batch = _make_batch(cfg, bank, rng, B=4)

    state1 = create_train_state(params, tx)
    full_step = jax.jit(make_train_step(model, tx))
    s_full, m_full = full_step(state1, batch)

    from camouflaged_vlm_tpu.train.train_step import SCANNED_BATCH_KEYS

    accum_batch = dict(batch)
    for k in SCANNED_BATCH_KEYS:
        x = batch[k]
        accum_batch[k] = x.reshape((2, 2) + x.shape[1:])
    state2 = create_train_state(params, tx)
    accum_step = jax.jit(make_train_step(model, tx, accum_steps=2))
    s_accum, m_accum = accum_step(state2, accum_batch)

    np.testing.assert_allclose(
        float(m_full["loss"]), float(m_accum["loss"]), rtol=2e-5
    )
    flat_f = jax.tree_util.tree_flatten_with_path(s_full.trainable)[0]
    flat_a = {p: v for p, v in jax.tree_util.tree_flatten_with_path(s_accum.trainable)[0]}
    for p, v in flat_f:
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(flat_a[p]), rtol=1e-4, atol=1e-6,
            err_msg=str(p),
        )
    assert int(s_accum.step) == 1  # one optimizer update, not accum_steps


@pytest.mark.slow  # ~1 min equality; the unsharded accum-equality test stays fast
def test_grad_accum_dp_mesh_matches_unsharded(tiny_train_setup, rng):
    """The accum step under a data-parallel mesh (microbatch dim sharded,
    leading accum dim replicated — cli/train.py's accum>1 sharding) matches
    the same step unsharded."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from camouflaged_vlm_tpu.parallel import make_mesh, shard_params
    from camouflaged_vlm_tpu.train.train_step import SCANNED_BATCH_KEYS

    cfg, model, bank, params = tiny_train_setup
    tx = optax.sgd(0.1)
    batch = _make_batch(cfg, bank, rng, B=4)
    accum_batch = dict(batch)
    for k in SCANNED_BATCH_KEYS:
        x = batch[k]
        accum_batch[k] = x.reshape((2, 2) + x.shape[1:])
    step = jax.jit(make_train_step(model, tx, accum_steps=2))

    s_plain, m_plain = step(create_train_state(params, tx), accum_batch)

    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    sharded_params = shard_params(mesh, params)
    sharded_batch = {}
    for k, v in accum_batch.items():
        spec = (
            P(None, "data", *([None] * (v.ndim - 2)))
            if k in SCANNED_BATCH_KEYS
            else P()
        )
        sharded_batch[k] = jax.device_put(v, NamedSharding(mesh, spec))
    with mesh:
        s_dp, m_dp = step(create_train_state(sharded_params, tx), sharded_batch)

    np.testing.assert_allclose(
        float(m_plain["loss"]), float(m_dp["loss"]), rtol=2e-5
    )
    flat_p = jax.tree_util.tree_flatten_with_path(s_plain.trainable)[0]
    flat_d = {p: v for p, v in jax.tree_util.tree_flatten_with_path(s_dp.trainable)[0]}
    for p, v in flat_p:
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(flat_d[p]), rtol=1e-4, atol=1e-6,
            err_msg=str(p),
        )


def test_maple_schedule_matches_dassl_semantics():
    """dassl ConstantWarmupScheduler (WARMUP_RECOUNT=True, the default the
    reference never overrides): warmup epochs run at the constant warmup lr,
    then the inner per-epoch CosineAnnealingLR(T_max=total) starts stepping
    from index 0 — the first post-warmup epoch runs at FULL base_lr and
    post-warmup epoch e at base*0.5*(1+cos(pi*(e-warmup)/total))."""
    import optax
    from camouflaged_vlm_tpu.train import make_maple_optimizer

    base, total, spe, warm, wlr = 0.0035, 10, 3, 1, 1e-5
    tx = make_maple_optimizer(
        base_lr=base, total_epochs=total, steps_per_epoch=spe,
        warmup_epochs=warm, warmup_lr=wlr,
    )
    # extract the schedule by probing sgd's update scaling on a unit grad
    params = {"w": jnp.zeros((1,))}
    state = tx.init(params)
    lrs = []
    for _ in range(5 * spe):
        updates, state = tx.update({"w": jnp.ones((1,))}, state, params)
        lrs.append(-float(updates["w"][0]))
    # SGD with momentum 0.9 on constant unit grads: first step's update is
    # exactly lr (momentum buffer == grad), so check step 0 and the first
    # step of each epoch via the ratio-free first-step values
    assert abs(lrs[0] - wlr) < 1e-12
    import math
    # assert directly with a fresh momentum-free probe:
    tx2 = make_maple_optimizer(
        base_lr=base, total_epochs=total, steps_per_epoch=1,
        warmup_epochs=warm, warmup_lr=wlr, momentum=0.0, weight_decay=0.0,
    )
    s2 = tx2.init(params)
    vals = []
    for _ in range(total):
        up, s2 = tx2.update({"w": jnp.ones((1,))}, s2, params)
        vals.append(-float(up["w"][0]))
    assert abs(vals[0] - wlr) < 1e-12
    # first post-warmup epoch: the cosine has not stepped yet -> full base_lr
    assert abs(vals[warm] - base) < 1e-9
    for e in range(warm, total):
        want = 0.5 * base * (1 + math.cos(math.pi * (e - warm) / total))
        assert abs(vals[e] - want) < 1e-9, (e, vals[e], want)


def test_fused_optimizer_updates_bitwise_equal(tiny_train_setup, rng):
    """`optax.flatten(adamw)` — cli/train's --fused-optimizer (the round-5
    train-glue attack: one raveled vector update instead of hundreds of
    per-leaf chains) — must produce BITWISE-identical updates: AdamW is
    purely elementwise, so raveling changes the program count, not the
    math. Updates are compared under identical input gradients across 3
    chained steps (not through a model forward, where fusion differences
    between the two compiled programs could reassociate grads and Adam
    would amplify near-zero-grad noise to full update scale — see
    test_hoisted_text_features_grads_match_bank_path)."""
    import optax

    from camouflaged_vlm_tpu.train.train_step import partition_params

    cfg, model, bank, params = tiny_train_setup
    trainable, _ = partition_params(params)
    tx_tree = make_optimizer(params)
    tx_flat = optax.flatten(make_optimizer(params))

    s_tree = tx_tree.init(trainable)
    s_flat = tx_flat.init(trainable)
    p_tree = trainable
    p_flat = trainable
    for step_i in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(
                rng.standard_normal(p.shape) * 1e-3, p.dtype
            ),
            p_tree,
        )
        u_tree, s_tree = jax.jit(tx_tree.update)(grads, s_tree, p_tree)
        u_flat, s_flat = jax.jit(tx_flat.update)(grads, s_flat, p_flat)
        p_tree = optax.apply_updates(p_tree, u_tree)
        p_flat = optax.apply_updates(p_flat, u_flat)
        for k in p_tree:
            np.testing.assert_array_equal(
                np.asarray(p_tree[k]), np.asarray(p_flat[k]),
                err_msg=f"step {step_i}, leaf {k}",
            )
