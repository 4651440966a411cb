"""Ingest the reference's REAL shipped text-feature banks.

These .pth files are the only actually-trained tensors available in this
environment — the reference loads them as the frozen per-class text-feature
bank (`/root/reference/models/sam_maskdecoder_edge.py:177-182`). Verifies
the production load path (`cli/common.load_torch_state_dict_as_array` ->
`assemble_cascade(text_bank_path=...)`) against the real files, then runs a
full cascade inference batch conditioned on the real 61-class test bank.

Regeneration parity (SURVEY §7.7 exit: `cli/precompute_text_bank.py`
reproduces these shipped 14x768/61x768 tensors from the prompt chain,
`/root/reference/cocotrainers/alphaCLIP.py:148-163`) is ENVIRONMENT-BLOCKED:
regeneration needs the real CLIP ViT-L/14-336 text-tower weights, which are
not in this image (zero egress; upstream blobs stripped). What is testable
without them is tested: the prompt/ensembling chain itself
(tests/test_text_bank.py pins camoprompts/imagenet80/attributes/CuPL
composition + pairwise ensembling on synthetic weights) and this file's
real-tensor ingestion. Repro on a machine with ViT-L-14-336px.pt:
  python -m camouflaged_vlm_tpu.cli.precompute_text_bank \\
      --clip-ckpt ViT-L-14-336px.pt --split test --out bank.npy
  # then compare np.load("bank.npy") with this file's TEST_BANK tensor.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES, TRAIN_CLASS_NAMES

REF_INFO = "/root/reference/datasets/ovcamo_info"
TRAIN_BANK = os.path.join(REF_INFO, "TrainCamoPromptsTextFeaturesViTB-14-336.pth")
TEST_BANK = os.path.join(REF_INFO, "TestCamoPromptsTextFeaturesViTB-14-336.pth")

pytestmark = pytest.mark.skipif(
    not (os.path.exists(TRAIN_BANK) and os.path.exists(TEST_BANK)),
    reason="reference ovcamo_info banks not mounted",
)


def test_real_banks_load_shape_and_norm():
    from camouflaged_vlm_tpu.cli.common import load_torch_state_dict_as_array

    train = load_torch_state_dict_as_array(TRAIN_BANK)
    test = load_torch_state_dict_as_array(TEST_BANK)
    # one row per class of each split, CLIP ViT-L/14@336 joint space width
    assert train.shape == (len(TRAIN_CLASS_NAMES), 768) == (14, 768)
    assert test.shape == (len(TEST_CLASS_NAMES), 768) == (61, 768)
    # the reference L2-normalises before saving (alphaCLIP.py mean+renorm)
    np.testing.assert_allclose(np.linalg.norm(train, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(test, axis=-1), 1.0, atol=1e-5)
    assert np.isfinite(train).all() and np.isfinite(test).all()


@pytest.mark.slow  # ~1.5 min; bank parsing/ingestion stays in the fast tier
def test_cascade_inference_with_real_test_bank():
    """assemble_cascade(--text-bank <real file>) end to end: a tiny cascade
    whose CLIP joint space is widened to the real 768 dims classifies a
    batch against the REAL 61-class bank."""
    from camouflaged_vlm_tpu.cli.common import assemble_cascade
    from camouflaged_vlm_tpu.models.cascade import CascadeConfig
    from camouflaged_vlm_tpu.models.clip.model import AlphaClipConfig

    base = CascadeConfig.tiny()
    cfg_in = dataclasses.replace(base, clip=AlphaClipConfig.tiny(embed_dim=768))
    model, cfg, params, bank, _ = assemble_cascade(
        TEST_CLASS_NAMES,
        config=cfg_in,
        text_bank_path=TEST_BANK,
        dtype=jnp.float32,
        return_bank_builder=True,
    )
    assert bank["bank_features"].shape == (61, 768)
    rng = np.random.default_rng(0)
    B = 2
    inp = jnp.asarray(rng.standard_normal((B, cfg.inp_size, cfg.inp_size, 3)), jnp.float32)
    cimg = jnp.asarray(rng.standard_normal((B, cfg.clip_size, cfg.clip_size, 3)), jnp.float32)
    cmask = jnp.full((B, cfg.clip_size, cfg.clip_size, 1), 1.923, jnp.float32)
    probs, pred, score = jax.jit(model.infer_cascade)(params, inp, cimg, cmask, bank["prefix"], bank["suffix"],
      bank["eot_indices"], bank["bank_features"])
    assert probs.shape == (B, cfg.inp_size, cfg.inp_size, 1)
    assert score.shape == (B, 61)
    assert np.isfinite(np.asarray(score)).all()
    assert ((np.asarray(pred) >= 0) & (np.asarray(pred) < 61)).all()
