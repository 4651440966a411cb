"""Checkpoint conversion tests.

Strategy: build a synthetic torch-layout state dict with exactly the
reference's key names/shapes (from the key map itself + torch oracle modules
for layout-sensitive ops), convert, and check (a) full coverage of the
parameter tree, (b) numerical equivalence of conv/convT/linear layers
(`models/layers.py`) against torch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camouflaged_vlm_tpu.models import CascadeConfig, OVCOSCascade
from camouflaged_vlm_tpu.models import layers as L
from camouflaged_vlm_tpu.factory import make_bank_inputs, init_cascade_params
from camouflaged_vlm_tpu.io.convert import (
    cascade_key_map,
    convert_state_dict,
    convert_openai_clip,
    convert_maple_prompt_learner,
    export_cascade_checkpoint,
    merge_into_params,
    _transform,
)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


@pytest.fixture(scope="module")
def tiny_setup(tiny_cascade_2class):
    # shared session fixture (conftest) — test_train builds the same thing
    return tiny_cascade_2class


def test_key_map_covers_every_param(tiny_setup):
    cfg, model, bank, params = tiny_setup
    flat = _flatten(jax.tree.map(np.asarray, params["params"]))
    key_map = cascade_key_map(cfg)
    mapped_paths = {fp for _, fp, _ in key_map}
    missing = sorted(set(flat) - mapped_paths)
    assert not missing, f"params not covered by key map: {missing}"
    extra = sorted(mapped_paths - set(flat))
    assert not extra, f"key map targets unknown params: {extra}"


def test_roundtrip_synthetic_checkpoint(tiny_setup):
    """Export the params to the reference's torch layout via the
    production exporter, convert it back, and check bit-identity + full
    coverage both ways."""
    cfg, model, bank, params = tiny_setup
    flat = _flatten(jax.tree.map(np.asarray, params["params"]))
    key_map = cascade_key_map(cfg)

    sd, export_missing = export_cascade_checkpoint(params, cfg)
    assert not export_missing  # every mapped torch key is exportable
    assert set(sd) == {tk for tk, _, _ in key_map}

    tree, missing, used = convert_state_dict(sd, key_map)
    assert not missing
    got = _flatten(tree)
    assert set(got) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)

    merged = merge_into_params(params, tree)
    got2 = _flatten(jax.tree.map(np.asarray, merged["params"]))
    for k in flat:
        np.testing.assert_array_equal(got2[k], flat[k], err_msg=k)


def test_linear_transform_matches_torch(rng):
    lin = torch.nn.Linear(6, 4)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    want = lin(torch.from_numpy(x)).detach().numpy()
    kernel = _transform("linear_w", lin.weight.detach().numpy())
    got = x @ kernel + lin.bias.detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_conv_transform_matches_torch(rng):
    conv = torch.nn.Conv2d(3, 5, kernel_size=4, stride=4)
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    want = (
        conv(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        .detach().numpy().transpose(0, 2, 3, 1)
    )
    kernel = _transform("conv_w", conv.weight.detach().numpy())
    got = L.conv(
        {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(conv.bias.detach().numpy())},
        jnp.asarray(x), 4, "VALID", jnp.float32,
    )
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


@pytest.mark.parametrize("k,s,pad_t,pad_f", [(2, 2, 0, "VALID"), (3, 1, 1, "SAME")])
def test_convtranspose_transform_matches_torch(rng, k, s, pad_t, pad_f):
    convt = torch.nn.ConvTranspose2d(4, 6, kernel_size=k, stride=s, padding=pad_t)
    x = rng.standard_normal((2, 5, 5, 4)).astype(np.float32)
    want = (
        convt(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        .detach().numpy().transpose(0, 2, 3, 1)
    )
    kernel = _transform("convT_w", convt.weight.detach().numpy())
    got = L.conv_transpose(
        {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(convt.bias.detach().numpy())},
        jnp.asarray(x), s, pad_f, jnp.float32,
    )
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_openai_clip_conversion_alpha_zero_init(tiny_setup):
    cfg, model, bank, params = tiny_setup
    clip_cfg = cfg.clip
    # synthetic raw OpenAI sd from the inverse of our clip subtree
    from camouflaged_vlm_tpu.io.convert import clip_key_map

    flat = _flatten(jax.tree.map(np.asarray, params["params"]))
    m = clip_key_map(clip_cfg, torch_prefix="", visual_in_proj_renamed=False)
    inverse = {
        "linear_w": lambda v: v.T,
        "conv_w": lambda v: v.transpose(3, 2, 0, 1),
        "direct": lambda v: v,
    }
    sd = {tk: inverse[kind](flat[fp]) for tk, fp, kind in m if fp in flat}
    sd.pop("visual.conv1_alpha.weight")  # raw OpenAI ckpt has no alpha conv
    sd["token_embedding.weight"] = np.zeros((clip_cfg.vocab_size, clip_cfg.transformer_width), np.float32)

    tree, token_embedding, missing = convert_openai_clip(sd, clip_cfg)
    assert not missing
    alpha = _flatten(tree)["clip_model/image_encoder/conv1_alpha/kernel"]
    assert np.all(alpha == 0) and alpha.shape[-2] == 1  # zero-init, 1 in-channel
    assert token_embedding.shape == (clip_cfg.vocab_size, clip_cfg.transformer_width)


def test_maple_checkpoint_conversion(tiny_setup):
    cfg, model, bank, params = tiny_setup
    clip_cfg = cfg.clip
    flat = _flatten(jax.tree.map(np.asarray, params["params"]))
    sd = {
        "prompt_learner.ctx": flat["clip_model/prompt_learner/ctx"],
        "prompt_learner.proj.weight": flat["clip_model/prompt_learner/proj/kernel"].T,
        "prompt_learner.proj.bias": flat["clip_model/prompt_learner/proj/bias"],
        "prompt_learner.token_prefix": np.zeros((2, 1, 4)),  # must be dropped
        "prompt_learner.token_suffix": np.zeros((2, 1, 4)),
    }
    for i in range(clip_cfg.prompt_depth - 1):
        sd[f"prompt_learner.compound_prompts_text.{i}"] = flat[
            f"clip_model/prompt_learner/compound_prompts_text_{i}"
        ]
        sd[f"prompt_learner.compound_prompt_projections.{i}.weight"] = flat[
            f"clip_model/prompt_learner/compound_prompt_proj_{i}/kernel"
        ].T
        sd[f"prompt_learner.compound_prompt_projections.{i}.bias"] = flat[
            f"clip_model/prompt_learner/compound_prompt_proj_{i}/bias"
        ]
    tree, missing, used = convert_maple_prompt_learner(sd, clip_cfg)
    assert not missing
    got = _flatten(tree)
    np.testing.assert_array_equal(
        got["clip_model/prompt_learner/ctx"], flat["clip_model/prompt_learner/ctx"]
    )

    # dassl PER-MODEL checkpoints save BARE keys ("ctx", "proj.weight", ...)
    # — must convert identically, not silently produce an empty tree
    bare = {k.split(".", 1)[1]: v for k, v in sd.items()}
    tree_b, missing_b, used_b = convert_maple_prompt_learner(bare, clip_cfg)
    assert not missing_b and len(used_b) == len(used)
    np.testing.assert_array_equal(
        _flatten(tree_b)["clip_model/prompt_learner/ctx"],
        flat["clip_model/prompt_learner/ctx"],
    )

    # an unrelated state dict must fail loudly, never load random prompts
    import pytest
    with pytest.raises(ValueError, match="no prompt-learner keys"):
        convert_maple_prompt_learner({"something.weight": np.zeros((2, 2))}, clip_cfg)


def test_restore_train_params_host_train_state_format(tiny_setup, tmp_path):
    """`restore_train_params_host` owns the orbax TrainState key format: the
    partitioned trainable/frozen flat dicts round-trip (tuple keys come back
    as repr strings) into the original params tree. The export CLI and
    consumers restore through this helper."""
    from camouflaged_vlm_tpu.io.checkpoint import (
        restore_train_params_host,
        save_checkpoint,
    )
    from camouflaged_vlm_tpu.train.optim import make_optimizer
    from camouflaged_vlm_tpu.train.train_step import create_train_state

    cfg, model, bank, params = tiny_setup
    state = create_train_state(params, make_optimizer(params))
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), state)

    got = restore_train_params_host(str(path))
    want = _flatten(jax.tree.map(np.asarray, params["params"]))
    got_flat = _flatten(jax.tree.map(np.asarray, got["params"]))
    assert set(got_flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(got_flat[k], want[k], err_msg=k)

    # bare params trees pass through unchanged
    save_checkpoint(str(tmp_path / "bare"), params)
    bare = restore_train_params_host(str(tmp_path / "bare"))
    got_flat = _flatten(jax.tree.map(np.asarray, bare["params"]))
    for k in want:
        np.testing.assert_array_equal(got_flat[k], want[k], err_msg=k)
