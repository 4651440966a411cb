"""Prompt-bank precompute tool: template modes, CuPL-GPT loading and the
cross-mode ensembling chain (reference `cocotrainers/alphaCLIP.py:117-244`)."""

import json

import numpy as np
import jax
import pytest

from camouflaged_vlm_tpu.cli.precompute_text_bank import (
    combine_banks,
    encode_gpt_bank,
    encode_text_features,
)
from camouflaged_vlm_tpu.data.templates import TEMPLATE_SETS
from camouflaged_vlm_tpu.models.clip import AlphaClipConfig
from camouflaged_vlm_tpu.models.clip import model as clip_model


@pytest.fixture(scope="module")
def tiny_text_tower():
    cfg = AlphaClipConfig.tiny()
    rng = np.random.default_rng(0)
    params = clip_model.init_text(cfg, jax.random.PRNGKey(0))
    token_embedding = rng.standard_normal(
        (cfg.vocab_size, cfg.transformer_width)
    ).astype(np.float32) * 0.02
    return cfg, params, token_embedding


def test_template_sets_present():
    assert set(TEMPLATE_SETS) >= {"camoprompts", "imagenet80", "attributes"}
    assert len(TEMPLATE_SETS["camoprompts"]) == 6
    assert len(TEMPLATE_SETS["imagenet80"]) == 80
    assert len(TEMPLATE_SETS["attributes"]) == 47  # reference ctx_templates size
    for s in TEMPLATE_SETS.values():
        assert all("{}" in t for t in s)


def test_bank_rows_unit_norm(tiny_text_tower):
    cfg, params, tok = tiny_text_tower
    bank = encode_text_features(
        cfg, params, tok, ["cat", "owl"], TEMPLATE_SETS["camoprompts"]
    )
    assert bank.shape == (2, cfg.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(bank, axis=-1), 1.0, atol=1e-5)


def test_gpt_bank_and_combine(tiny_text_tower, tmp_path):
    cfg, params, tok = tiny_text_tower
    gpt = {
        "Tree_Frog": ["a frog on a leaf.", "a green tree frog."],
        "cat": ["a cat.", "a sleeping cat.", "a cat in grass."],
    }
    path = tmp_path / "cupl.json"
    path.write_text(json.dumps(gpt))
    # key matching is lowercase with underscores as spaces (alphaCLIP.py:203)
    bank = encode_gpt_bank(cfg, params, tok, ["tree frog", "CAT"], str(path))
    assert bank.shape == (2, cfg.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(bank, axis=-1), 1.0, atol=1e-5)

    other = encode_text_features(
        cfg, params, tok, ["tree frog", "CAT"], TEMPLATE_SETS["attributes"]
    )
    combined = combine_banks([other, bank])
    # pairwise mean + renorm (alphaCLIP.py:216-222)
    want = np.stack([other, bank]).mean(axis=0)
    want /= np.linalg.norm(want, axis=-1, keepdims=True)
    np.testing.assert_allclose(combined, want, atol=1e-7)
    # single-bank passthrough
    np.testing.assert_array_equal(combine_banks([bank]), bank)


def test_gpt_bank_empty_prompt_list_raises(tiny_text_tower, tmp_path):
    """A class whose CuPL prompt list is empty must fail with a clear error,
    not a bare IndexError from the pad-to-bucket path."""
    cfg, params, tok = tiny_text_tower
    path = tmp_path / "cupl.json"
    path.write_text(json.dumps({"cat": []}))
    with pytest.raises(ValueError, match="empty prompt list"):
        encode_gpt_bank(cfg, params, tok, ["cat"], str(path))


def test_cli_mode_order_follows_reference(monkeypatch, tiny_text_tower, tmp_path):
    """The ensembling chain is order-sensitive; the CLI must fold banks in
    the reference's fixed sequence imagenet80 -> camoprompts -> CuPL-GPT ->
    attributes regardless of --templates spelling."""
    import camouflaged_vlm_tpu.cli.precompute_text_bank as ptb

    cfg, params, tok = tiny_text_tower
    order = []
    monkeypatch.setattr(
        ptb, "encode_text_features",
        lambda *a, **k: (order.append(("tpl", len(a[4]))), np.ones((1, 4)))[1],
    )
    monkeypatch.setattr(
        ptb, "encode_gpt_bank",
        lambda *a, **k: (order.append(("gpt", 0)), np.ones((1, 4)))[1],
    )
    monkeypatch.setattr(ptb, "load_openai_clip_state_dict", lambda p: {})
    monkeypatch.setattr(
        ptb, "convert_openai_clip",
        lambda sd, cfg_: ({"clip_model": {"text_encoder": params}}, tok, []),
    )
    gpt_path = tmp_path / "cupl.json"
    gpt_path.write_text(json.dumps({"cat": ["a cat."]}))
    out = tmp_path / "bank.npy"
    monkeypatch.setattr(
        "sys.argv",
        ["prog", "--clip-ckpt", "x", "--classnames", "cat",
         "--templates", "attributes,camoprompts,imagenet80",
         "--gpt-json", str(gpt_path), "--out", str(out)],
    )
    ptb.main()
    sizes = [len(TEMPLATE_SETS[m]) for m in ("imagenet80", "camoprompts")]
    assert order == [("tpl", sizes[0]), ("tpl", sizes[1]), ("gpt", 0),
                     ("tpl", len(TEMPLATE_SETS["attributes"]))]
