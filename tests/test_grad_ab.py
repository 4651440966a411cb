"""Gradient-level A/B against the reference's own training backward.

The loss FUNCTIONS are torch-oracle tested (tests/test_train.py /
test_models.py) and the forward is golden-tested — but the gradients of
the loss through the WHOLE cascade were only ever compared between our own
Pallas backwards and XLA autodiff. This runs the reference's actual
training step surface — `SAM.forward()` + `backward_G()` (torch autograd,
`/root/reference/models/sam_maskdecoder_edge.py:272-303,429-454`) with the
reference train script's freeze rule (`train_ovcos_maskdecoder_edge.py:
301-303`) — and compares every trainable parameter's gradient, converted
through the same key map as the weights, against `jax.grad` of our
training loss. Catches train-branch-only wiring (train-split prompt path,
loss stacking, stop-gradient placement, frozen-subtree boundaries).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from camouflaged_vlm_tpu.io.convert import convert_state_dict, cascade_key_map
from camouflaged_vlm_tpu.train.losses import segmentation_loss
from camouflaged_vlm_tpu.data.transforms import ONES_ALPHA_VALUE

from test_eval_ab import _build_pair, INP, CLIP

pytestmark = pytest.mark.slow  # ~2 min two-framework backward


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = np.asarray(tree)
    return out


def test_train_gradients_match_reference():
    rng = np.random.default_rng(21)
    tsam, model, cfg, params, _test_bank = _build_pair(rng)

    # reference freeze rule: image_encoder except prompt_generator; CLIP is
    # already frozen by load_mapleAlphaCLIP
    for name, p in tsam.image_encoder.named_parameters():
        p.requires_grad = "prompt_generator" in name
    tsam.train()

    # TEST-split prompt constants. This is the reference's ACTUAL training
    # conditioning — found by this very test: `maple_alpha_clip_process`
    # passes `self.training` into CustomCLIP.forward's `label` slot
    # (`models/sam_maskdecoder_edge.py:269` vs `mapleAlphaCLIP.py:264`
    # signature `(image, mask, label=None, train=False)`), so train=False
    # and the TEST-branch prompts/bank condition the decoder at every
    # training step; the CLIP "train branch" is dead in the cascade.
    # cli/train.py replicates the quirk (see its static_bank comment).
    pl = tsam.clip_model.prompt_learner
    prefix = jnp.asarray(pl.token_prefix_test.detach().numpy())
    suffix = jnp.asarray(pl.token_suffix_test.detach().numpy())
    eot = jnp.asarray(
        pl.tokenized_prompts_test.argmax(dim=-1).numpy().astype(np.int32)
    )
    train_bank = jnp.asarray(tsam.test_text_features.detach().numpy())

    inp = rng.standard_normal((1, INP, INP, 3)).astype(np.float32)
    cimg = rng.standard_normal((1, CLIP, CLIP, 3)).astype(np.float32)
    cmask = np.full((1, CLIP, CLIP, 1), ONES_ALPHA_VALUE, np.float32)
    gt = (rng.random((1, INP, INP, 1)) > 0.6).astype(np.float32)

    # ---- reference: forward() + backward_G() (torch autograd) ----
    tsam.set_input(
        torch.from_numpy(np.moveaxis(inp, 3, 1).copy()),
        torch.from_numpy(np.moveaxis(gt, 3, 1).copy()),
        torch.tensor([0]),
        torch.from_numpy(np.moveaxis(cimg, 3, 1).copy()),
        torch.from_numpy(np.moveaxis(cmask, 3, 1).copy()),
    )
    tsam.device = torch.device("cpu")
    # precondition: both frameworks pick the same class (the pick selects
    # the decoder's text prompt; ties would flip on fp32 noise and the
    # comparison would measure chaos, not parity)
    with torch.no_grad():
        _, _, tpred, _ = tsam.maple_alpha_clip_process(
            tsam.clip_image, tsam.clip_mask
        )
    _, _, _, jpred, _ = model.stage1(
        params, jnp.asarray(inp), jnp.asarray(cimg), jnp.asarray(cmask),
        prefix, suffix, eot, train_bank,
    )
    assert int(tpred[0]) == int(np.asarray(jpred)[0])

    tsam.forward()
    tsam.backward_G()
    want_loss = float(tsam.loss_G)
    want_mask_loss = float(tsam.loss_dict["loss_mask"])
    want_edge_loss = float(tsam.loss_dict["loss_edge"])

    tgrads = {
        k: p.grad.detach().numpy()
        for k, p in tsam.named_parameters()
        if p.grad is not None
    }
    assert any("prompt_generator" in k for k in tgrads)
    assert any("mask_decoder" in k for k in tgrads)
    assert not any("clip_model" in k for k in tgrads)  # frozen tower
    # grads transform under the SAME linear rearrangements as the weights
    want_tree, _missing, _ = convert_state_dict(tgrads, cascade_key_map(cfg))
    want_flat = _flatten(want_tree)
    assert want_flat, "no reference gradients converted"

    # ---- ours: jax.grad of the training loss ----
    def loss_fn(p):
        masks, edges = model(
            p, jnp.asarray(inp), jnp.asarray(cimg), jnp.asarray(cmask),
            prefix, suffix, eot, train_bank,
        )
        total, parts = segmentation_loss(masks, edges, jnp.asarray(gt), "iou")
        return total, parts

    (got_loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    np.testing.assert_allclose(float(got_loss), want_loss, atol=2e-4)
    np.testing.assert_allclose(
        float(parts["loss_mask"]), want_mask_loss, atol=2e-4
    )
    np.testing.assert_allclose(
        float(parts["loss_edge"]), want_edge_loss, atol=2e-4
    )

    got_flat = _flatten(grads["params"] if "params" in grads else grads)
    # compare every reference-trainable leaf; tolerance scales with the
    # leaf's gradient magnitude (fp32 cross-framework reassociation)
    checked = 0
    for key, want in want_flat.items():
        gkey = key[len("params/"):] if key.startswith("params/") else key
        got = got_flat.get(gkey)
        if got is None:
            got = got_flat.get(key)
        assert got is not None, f"no jax grad for {key}"
        assert got.shape == want.shape, (key, got.shape, want.shape)
        scale = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(
            got, want, atol=3e-3 * scale + 1e-7, err_msg=key
        )
        checked += 1
    assert checked > 30, checked  # decoder + projections + EVP MLPs
