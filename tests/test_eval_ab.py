"""End-to-end EVAL-vs-EVAL A/B against the reference's own eval script.

Both sides run the COMPLETE eval pipeline on the same tiny synthetic OVCamo
directory with IDENTICAL weights (the reference's torch modules randomised,
then converted into our params) and identical per-image inputs (built from
our loader's decoded arrays, normalised with the same arithmetic the
reference's ValDataset applies):

  reference: `eval_psnr_ovcamo_both` from the reference's own
      `test_ovcos_maskdecoder_edge.py`, loaded verbatim via
      tests/_reference_oracle.load_ref_eval_module — its real calc_cod,
      OVCOSMetricer, Classification, cv2 float resize + *255 truncation.
  ours: `cli.evaluate.evaluate` — the production eval loop (fused two-stage
      jitted program, pipelined drain, threaded metric pool).

Compared: the FULL results dicts — class-agnostic COD (ori_*), all 12
class-aware OVCOS metrics, top1/top5/macroF1 — plus the saved per-image
prediction PNGs pixel-by-pixel.

The single size-specific literal in the reference eval loop —
`F.interpolate(pred_mask, (336, 336))` at :111 — is redirected to the tiny
CLIP resolution (28); everything else runs the reference's code unmodified.

Numeric-regime caveat: random N(0, 0.05) weights leave
the tiny decoder's mask logits in a ±0.006 band, so sigmoid probabilities
cluster at 0.5±0.001 — every threshold-sweep metric degenerates and fp16
mask transfer would quantise the whole band to ~3 values. The fixture
therefore scales the hypernetwork OUTPUT layers x300 **in the shared torch
state dict, before conversion** — both frameworks consume the identical
sharpened weights, so the A/B still compares like with like; it just runs
on sharpened synthetic masks rather than realistic mask statistics. This
does not weaken the real-weights argument: trained checkpoints produce
sharp logits natively (no scaling path exists in production code), the
threshold-sweep metric code exercised here is input-distribution-agnostic
and separately pinned against the reference's metricer at 1e-8/1e-10 on
ARBITRARY prob maps (tests/test_ovcos_oracle.py), and real-weights numeric
agreement rests on the full-size activation A/B (mask logits 2.4e-6,
scripts/ab_fullsize_cpu.py).
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from PIL import Image

from camouflaged_vlm_tpu.cli.evaluate import evaluate
from camouflaged_vlm_tpu.data.loader import iter_eval_batches
from camouflaged_vlm_tpu.data.ovcamo import OVCamoIndex
from camouflaged_vlm_tpu.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ONES_ALPHA_VALUE,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
)
from camouflaged_vlm_tpu.io.convert import (
    cascade_key_map,
    convert_state_dict,
    merge_into_params,
)
from camouflaged_vlm_tpu.models.cascade import CascadeConfig, OVCOSCascade
from camouflaged_vlm_tpu.models.mask_decoder import MaskDecoderConfig
from camouflaged_vlm_tpu.models.sam_encoder import SamEncoderConfig
from camouflaged_vlm_tpu.models.two_way_transformer import TwoWayTransformerConfig

from _reference_oracle import (
    load_ref_cascade_module,
    load_ref_eval_module,
    randomize_torch_module,
)
from test_golden_parity import (
    ENC_TINY,
    TEST_NAMES,
    TRAIN_NAMES,
    _our_clip_cfg,
    _sd_numpy,
    _torch_custom_clip,
)

pytestmark = pytest.mark.slow  # ~2.5 min two-framework eval; nightly tier

INP, CLIP = 64, 28
SIZES = [(50, 70), (90, 40), (64, 64), (33, 77), (128, 96), (45, 45)]

OVCOS_KEYS = (
    "sm", "wfm", "mae", "adpfm", "maxfm", "avgfm",
    "adpem", "maxem", "avgem", "adpiou", "maxiou", "avgiou",
)


@pytest.fixture(scope="module")
def synth_ovcamo(tmp_path_factory):
    """Tiny OVCamo test split: 6 images over the 5 golden-test classes,
    original sizes both smaller and larger than the 64px model resolution
    (exercises up- AND down-scaling in the pred->original resize)."""
    root = tmp_path_factory.mktemp("ovcamo_ab")
    rng = np.random.default_rng(7)
    (root / "image").mkdir()
    (root / "mask").mkdir()
    class_infos = [{"name": n, "split": "test"} for n in TEST_NAMES]
    sample_infos = []
    for i, (h, w) in enumerate(SIZES):
        uid = f"img{i}"
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / "image" / f"{uid}.jpg", quality=95)
        # smooth blob mask (binary, 8-bit gray PNG — cv2.imread(GRAYSCALE)
        # and PIL convert("L") agree byte-for-byte on this container)
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        r = 0.25 * min(h, w)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8) * 255
        Image.fromarray(mask).save(root / "mask" / f"{uid}.png")
        sample_infos.append(
            {
                "unique_id": uid,
                "base_class": TEST_NAMES[i % len(TEST_NAMES)],
                "image": f"{uid}.jpg",
                "mask": f"{uid}.png",
            }
        )
    (root / "class_info.json").write_text(json.dumps(class_infos))
    (root / "sample_info.json").write_text(json.dumps(sample_infos))
    return {
        "OVCamo_CLASS_JSON_PATH": str(root / "class_info.json"),
        "OVCamo_SAMPLE_JSON_PATH": str(root / "sample_info.json"),
        "OVCamo_TE_IMAGE_DIR": str(root / "image"),
        "OVCamo_TE_MASK_DIR": str(root / "mask"),
        "OVCamo_TR_IMAGE_DIR": str(root / "image"),
        "OVCamo_TR_MASK_DIR": str(root / "mask"),
    }


def _build_pair(rng):
    """Identically-weighted (reference torch cascade, our cascade) pair —
    same construction as test_golden_parity.test_cascade_infer_test_golden_parity."""
    train_bank = torch.zeros(len(TRAIN_NAMES), 768)
    test_bank = torch.from_numpy(
        rng.standard_normal((len(TEST_NAMES), 768)).astype(np.float32) * 0.1
    )
    mod = load_ref_cascade_module(train_bank, test_bank)
    SAM = mod._registry["sam_maskdecoder_edge"]
    encoder_mode = dict(
        embed_dim=ENC_TINY["embed_dim"], patch_size=ENC_TINY["patch_size"],
        depth=ENC_TINY["depth"], num_heads=ENC_TINY["num_heads"],
        mlp_ratio=ENC_TINY["mlp_ratio"], out_chans=256, qkv_bias=True,
        use_rel_pos=True, window_size=ENC_TINY["window_size"],
        global_attn_indexes=ENC_TINY["global_attn_indexes"],
        prompt_embed_dim=256,
    )
    orig_load = torch.load
    torch.load = mod._bank_loader
    try:
        tsam = SAM(inp_size=INP, encoder_mode=encoder_mode, loss="iou")
    finally:
        torch.load = orig_load
    randomize_torch_module(tsam, seed=3)
    # N(0, 0.05) weights leave the mask logits in a ±0.006 band around 0 —
    # sigmoid probs all ≈ 0.5, which makes every threshold metric
    # degenerate (and fp16 transfer would quantise the whole band to ~3
    # values). Widen the logits by scaling the hypernetwork output layers:
    # both sides see the SAME state dict, so this only de-degenerates the
    # comparison.
    with torch.no_grad():
        for mlp in tsam.mask_decoder.output_hypernetworks_mlps:
            mlp.layers[-1].weight *= 300.0
            mlp.layers[-1].bias *= 300.0
    tcc = _torch_custom_clip(seed=4)
    tsam.load_mapleAlphaCLIP(tcc)
    tsam.eval()

    cfg = CascadeConfig(
        inp_size=INP, clip_size=CLIP, prompt_embed_dim=256,
        encoder=SamEncoderConfig(
            **{**ENC_TINY, "out_chans": 256}, prompt_scale_factor=32,
            attn_impl="reference", gelu_approximate=False,
        ),
        decoder=MaskDecoderConfig(
            transformer=TwoWayTransformerConfig(
                embedding_dim=256, num_heads=8, mlp_dim=2048
            ),
        ),
        clip=_our_clip_cfg(),
    )
    model = OVCOSCascade(cfg)

    bank = {
        "prefix": jnp.asarray(tcc.prompt_learner.token_prefix_test.numpy()),
        "suffix": jnp.asarray(tcc.prompt_learner.token_suffix_test.numpy()),
        "eot_indices": jnp.asarray(
            tcc.prompt_learner.tokenized_prompts_test.argmax(dim=-1)
            .numpy().astype(np.int32)
        ),
        "bank_features": jnp.asarray(test_bank.numpy()),
    }

    B = 1
    inp = np.zeros((B, INP, INP, 3), np.float32)
    cimg = np.zeros((B, CLIP, CLIP, 3), np.float32)
    cmask = np.full((B, CLIP, CLIP, 1), ONES_ALPHA_VALUE, np.float32)
    args = (
        jnp.asarray(inp), jnp.asarray(cimg), jnp.asarray(cmask),
        bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"],
    )
    params = model.init(jax.random.PRNGKey(0))
    tree, missing, _ = convert_state_dict(_sd_numpy(tsam), cascade_key_map(cfg))
    assert not missing, missing
    params = merge_into_params(params, tree)
    return tsam, model, cfg, params, bank


class _FakeLoader:
    """Duck-typed stand-in for the reference's DataLoader-over-ValDataset:
    iterable of batch dicts + `.dataset.dataset.classes`."""

    def __init__(self, batches, classes):
        self._batches = batches
        self.dataset = types.SimpleNamespace(
            dataset=types.SimpleNamespace(classes=list(classes))
        )

    def __len__(self):
        return len(self._batches)

    def __iter__(self):
        return iter(self._batches)


def _torch_batches(index):
    """Batch-1 dicts with the reference ValDataset's keys, built from OUR
    loader's decoded uint8 arrays + the same normalisation arithmetic the
    in-graph path applies — input equality by construction (the raw
    preprocessing itself is covered byte-for-byte by
    tests/test_data_pipeline.py / test_native_preproc.py)."""
    batches = []
    for b in iter_eval_batches(index, 1, INP, CLIP, num_workers=0, raw_uint8=True):
        s = b[0]
        inp = (s.inp.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        cimg = (
            s.clip_image.astype(np.float32) / 255.0 - OPENAI_CLIP_MEAN
        ) / OPENAI_CLIP_STD
        batches.append(
            {
                "inp": torch.from_numpy(np.moveaxis(inp, 2, 0)[None].copy()),
                "gt": torch.from_numpy(np.moveaxis(s.gt, 2, 0)[None].copy()),
                "label_id": torch.tensor([s.label_id]),
                "label_name": [s.label_name],
                "clip_image": torch.from_numpy(np.moveaxis(cimg, 2, 0)[None].copy()),
                "clip_mask": torch.full((1, 1, CLIP, CLIP), ONES_ALPHA_VALUE),
                "mask_path": [s.mask_path],
            }
        )
    return batches


def test_eval_pipeline_ab_matches_reference(synth_ovcamo, tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    tsam, model, cfg, params, bank = _build_pair(rng)
    index = OVCamoIndex.from_dataset_info(synth_ovcamo, "test")
    assert index.classes == TEST_NAMES  # identical id->name mapping both sides

    ref_eval = load_ref_eval_module()

    # capture the full dicts the reference function computes but only logs
    captured = {}
    RefMetricer = ref_eval.recorder.OVCOSMetricer

    class CapMetricer(RefMetricer):
        def show(self, *a, **k):
            r = super().show(*a, **k)
            captured["ovcos"] = dict(r)
            return r

    RefClf = ref_eval.Classification

    class CapClf(RefClf):
        def evaluate(self):
            r = super().evaluate()
            captured["clf"] = dict(r)
            return r

    monkeypatch.setattr(ref_eval.recorder, "OVCOSMetricer", CapMetricer)
    monkeypatch.setattr(ref_eval, "Classification", CapClf)
    # CPU-only torch: neutralise the .cuda() calls in the eval loop
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    # the one size-specific literal: alpha handoff 336 -> tiny CLIP res
    real_F = ref_eval.F

    def _interp(x, size, **kw):
        if tuple(size) == (336, 336):
            size = (CLIP, CLIP)
        return real_F.interpolate(x, size, **kw)

    monkeypatch.setattr(
        ref_eval, "F", types.SimpleNamespace(interpolate=_interp)
    )

    ref_dir = tmp_path / "ref_imgs"
    our_dir = tmp_path / "our_imgs"
    loader = _FakeLoader(_torch_batches(index), index.classes)
    with torch.no_grad():
        ref_out = ref_eval.eval_psnr_ovcamo_both(loader, tsam, str(ref_dir))
    (ref_sm, ref_wfm, ref_mae, ref_avgfm, ref_avgem, ref_avgiou,
     ref_ori_sm, ref_ori_em, ref_ori_wfm, ref_ori_mae) = [float(v) for v in ref_out]

    ours = evaluate(
        model, cfg, params, bank, index,
        batch_size=2, save_img_path=str(our_dir), num_workers=2,
        mask_dtype="float32",
    )

    # --- class-agnostic COD metrics (model-res float path) ---
    # tolerances: stage-1 logits agree at ~5e-4 across frameworks (golden
    # cascade test); threshold-sweep metrics wobble by O(1e-3) from that
    np.testing.assert_allclose(ours["ori_sm"], ref_ori_sm, atol=2e-3)
    np.testing.assert_allclose(ours["ori_em"], ref_ori_em, atol=2e-3)
    np.testing.assert_allclose(ours["ori_wfm"], ref_ori_wfm, atol=2e-3)
    np.testing.assert_allclose(ours["ori_mae"], ref_ori_mae, atol=2e-3)

    # --- class-aware OVCOS metrics (original-res uint8 host path) ---
    assert set(OVCOS_KEYS) <= set(captured["ovcos"]), captured["ovcos"]
    for k in OVCOS_KEYS:
        np.testing.assert_allclose(
            ours[k], float(captured["ovcos"][k]), atol=3e-3, err_msg=k
        )
    # the function's own return values agree with its dict (sanity)
    np.testing.assert_allclose(ref_sm, float(captured["ovcos"]["sm"]), atol=1e-6)

    # --- classification (argmax-stable: exact) ---
    for k in ("accuracy", "top5", "macro_f1"):
        np.testing.assert_allclose(
            ours[k], round(float(captured["clf"][k]), 2), atol=1e-6, err_msg=k
        )

    # --- saved per-image predictions: same files, near-identical pixels ---
    ref_files = sorted(os.listdir(ref_dir))
    our_files = sorted(os.listdir(our_dir))
    assert ref_files == our_files  # same [pred_cls]name.png naming
    total = agree = 0
    for f in ref_files:
        a = np.asarray(Image.open(ref_dir / f).convert("L"), np.int16)
        b = np.asarray(Image.open(our_dir / f).convert("L"), np.int16)
        assert a.shape == b.shape, f
        d = np.abs(a - b)
        assert d.max() <= 1, (f, d.max())  # only uint8-bin boundary flips
        total += d.size
        agree += int((d == 0).sum())
    assert agree / total > 0.99, (agree, total)