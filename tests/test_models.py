"""Shape/structure/numerics tests for the model stack (tiny configs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from camouflaged_vlm_tpu.models import (
    SamEncoderConfig,
    MaskDecoderConfig,
    TwoWayTransformerConfig,
    CascadeConfig,
    OVCOSCascade,
)
from camouflaged_vlm_tpu.models import mask_decoder, sam_encoder, two_way_transformer
from camouflaged_vlm_tpu.models.position_embedding import random_position_embedding
from camouflaged_vlm_tpu.models.clip import (
    AlphaClipConfig,
    build_class_prompt_bank,
    custom_clip,
    tokenize,
)


@pytest.fixture(scope="module")
def tiny_cascade():
    cfg = CascadeConfig.tiny()
    model = OVCOSCascade(cfg)
    rng = np.random.default_rng(0)
    tok_emb = (
        rng.standard_normal((cfg.clip.vocab_size, cfg.clip.transformer_width)).astype(
            np.float32
        )
        * 0.02
    )
    bank = build_class_prompt_bank(
        ["cat", "owl", "snow leopard"], tok_emb, n_ctx=cfg.clip.n_ctx
    )
    bank_feat = jnp.asarray(
        rng.standard_normal((3, cfg.clip.embed_dim)).astype(np.float32)
    )
    B = 2
    args = (
        jnp.asarray(rng.standard_normal((B, cfg.inp_size, cfg.inp_size, 3)), jnp.float32),
        jnp.asarray(rng.standard_normal((B, cfg.clip_size, cfg.clip_size, 3)), jnp.float32),
        jnp.ones((B, cfg.clip_size, cfg.clip_size, 1)),
        jnp.asarray(bank.prefix),
        jnp.asarray(bank.suffix),
        jnp.asarray(bank.eot_indices),
        bank_feat,
    )
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, args


def test_encoder_shapes_and_interm():
    cfg = SamEncoderConfig.tiny()
    x = jnp.zeros((2, cfg.img_size, cfg.img_size, 3))
    params = sam_encoder.init(cfg, jax.random.PRNGKey(0))
    y, interm = sam_encoder.apply(cfg, params, x, interm=True)
    assert y.shape == (2, cfg.grid, cfg.grid, cfg.out_chans)
    assert len(interm) == len(cfg.global_attn_indexes)
    for t in interm:
        assert t.shape == (2, cfg.grid, cfg.grid, cfg.embed_dim)


def test_encoder_freeze_rule_param_paths():
    """The finetune freeze rule needs prompt_generator params under one subtree."""
    cfg = SamEncoderConfig.tiny()
    params = sam_encoder.init(cfg, jax.random.PRNGKey(0))
    keys = params.keys()
    assert "prompt_generator" in keys
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    prompt_params = [p for p, _ in flat if any("prompt_generator" in str(k) for k in p)]
    assert len(prompt_params) >= cfg.depth + 3  # per-block MLPs + shared + embed + handcrafted


def test_position_embedding_matches_reference_formula(rng):
    g = rng.standard_normal((2, 8)).astype(np.float32)
    pe = np.asarray(random_position_embedding(jnp.asarray(g), 4))
    assert pe.shape == (4, 4, 16)
    # manual formula for pixel (i, j): coords = ((j+0.5)/4, (i+0.5)/4)
    i, j = 2, 1
    coords = np.array([(j + 0.5) / 4, (i + 0.5) / 4], np.float32)
    proj = 2 * np.pi * ((2 * coords - 1) @ g)
    want = np.concatenate([np.sin(proj), np.cos(proj)])
    np.testing.assert_allclose(pe[i, j], want, atol=1e-5)


def test_two_way_transformer_shapes():
    cfg = TwoWayTransformerConfig(embedding_dim=32, num_heads=4, mlp_dim=64)
    B, N, T, S = 2, 16, 6, 2
    img = jnp.ones((B, N, 32))
    pe = jnp.ones((B, N, 32))
    tok = jnp.ones((B, T, 32))
    cond = jnp.ones((B, S, 32))
    params = two_way_transformer.init(cfg, jax.random.PRNGKey(0))
    q, k = two_way_transformer.apply(cfg, params, img, pe, tok, cond)
    assert q.shape == (B, T, 32) and k.shape == (B, N, 32)


def test_mask_decoder_multimask_slicing():
    cfg = MaskDecoderConfig(
        transformer_dim=32,
        transformer=TwoWayTransformerConfig(embedding_dim=32, num_heads=4, mlp_dim=64),
    )
    B, h, w = 2, 4, 4
    img = jnp.ones((B, h, w, 32))
    pe = jnp.ones((h, w, 32))
    sparse = jnp.ones((B, 2, 32))
    dense = jnp.zeros((B, h, w, 32))
    params = mask_decoder.init(cfg, jax.random.PRNGKey(0))
    m1, e1, i1 = mask_decoder.apply(cfg, params, img, pe, sparse, dense, multimask_output=False)
    m3, e3, i3 = mask_decoder.apply(cfg, params, img, pe, sparse, dense, multimask_output=True)
    assert m1.shape == (B, 1, 4 * h, 4 * w) and i1.shape == (B, 1)
    assert m3.shape == (B, 3, 4 * h, 4 * w) and i3.shape == (B, 3)
    assert e1.shape == (B, 1, 4 * h, 4 * w)
    assert np.all(np.asarray(e1) >= 0) and np.all(np.asarray(e1) <= 1)


def test_tokenizer_known_clip_ids():
    ids = tokenize("a photo of a cat.")[0]
    assert list(ids[:8]) == [49406, 320, 1125, 539, 320, 2368, 269, 49407]
    # EOT position is argmax
    assert ids.argmax() == 7


def test_tokenizer_non_ascii_normalisation():
    """NFC composition before byte-level BPE — the ftfy-equivalent cleanup
    the reference applies (`alpha_clip_rw/simple_tokenizer.py:50-53`).
    A combining-accent "café" must tokenize like the precomposed form, and
    html entities must resolve (double-unescape like the reference)."""
    composed = tokenize("a photo of a café.")[0]
    decomposed = tokenize("a photo of a café.")[0]
    np.testing.assert_array_equal(composed, decomposed)
    # sanity: the non-ascii word actually produced non-trivial ids
    assert composed.argmax() > 6

    entity = tokenize("black &amp;amp; white cat")[0]
    literal = tokenize("black & white cat")[0]
    np.testing.assert_array_equal(entity, literal)

    # NFC must run AFTER entity unescape: a combining mark arriving as an
    # html entity composes before BPE (ftfy unescapes, then NFC-composes).
    entity_accent = tokenize("a photo of a cafe&#769;.")[0]
    np.testing.assert_array_equal(entity_accent, tokenize("a photo of a café.")[0])


def test_tokenizer_mojibake_repair():
    """ftfy's encoding repair (`alpha_clip_rw/simple_tokenizer.py:50-53`):
    UTF-8 read as latin-1/windows-1252 is re-decoded, so a mojibake prompt
    tokenizes like the intended text; legitimate accents and non-latin text
    pass through untouched."""
    # "café" mis-decoded as latin-1 -> "cafÃ©"
    np.testing.assert_array_equal(
        tokenize("a photo of a cafÃ©.")[0], tokenize("a photo of a café.")[0]
    )
    # windows-1252 C1-range mojibake: "’" (U+2019) -> "â€™"
    np.testing.assert_array_equal(
        tokenize("the catâ€™s paw")[0], tokenize("the cat’s paw")[0]
    )
    # doubly-encoded mojibake repairs through two passes
    double = "café".encode("utf-8").decode("latin-1").encode("utf-8").decode("latin-1")
    np.testing.assert_array_equal(
        tokenize(f"a {double} cat")[0], tokenize("a café cat")[0]
    )
    # legitimate accented text is NOT valid UTF-8 as latin-1 bytes: unchanged
    plain = tokenize("déjà vu")[0]
    assert plain.argmax() > 2  # tokenized normally, non-trivially
    # chars outside latin-1 abort the repair and tokenize as themselves
    cjk = tokenize("日本")[0]
    assert cjk.argmax() > 2


def test_clip_prompt_bank_structure():
    cfg = AlphaClipConfig.tiny()
    rng = np.random.default_rng(1)
    tok_emb = rng.standard_normal((cfg.vocab_size, cfg.transformer_width)).astype(np.float32)
    bank = build_class_prompt_bank(["cat", "owl"], tok_emb, n_ctx=cfg.n_ctx)
    assert bank.tokenized.shape == (2, 77)
    assert bank.prefix.shape == (2, 1, cfg.transformer_width)
    assert bank.suffix.shape == (2, 77 - 1 - cfg.n_ctx, cfg.transformer_width)
    # prefix is the SOT embedding
    np.testing.assert_array_equal(bank.prefix[0, 0], tok_emb[49406])


def test_clip_alpha_sensitivity():
    """Image features must depend on the alpha channel (the Alpha-CLIP core idea)."""
    cfg = AlphaClipConfig.tiny()
    rng = np.random.default_rng(2)
    tok_emb = rng.standard_normal((cfg.vocab_size, cfg.transformer_width)).astype(np.float32) * 0.02
    bank = build_class_prompt_bank(["cat", "owl"], tok_emb, n_ctx=cfg.n_ctx)
    bank_feat = jnp.zeros((2, cfg.embed_dim))
    img = jnp.asarray(rng.standard_normal((1, 28, 28, 3)), jnp.float32)
    a1 = jnp.ones((1, 28, 28, 1))
    a0 = jnp.zeros((1, 28, 28, 1))
    args = (jnp.asarray(bank.prefix), jnp.asarray(bank.suffix), jnp.asarray(bank.eot_indices), bank_feat)
    params = custom_clip.init(cfg, jax.random.PRNGKey(0))
    f1, _, _, _ = custom_clip.apply(cfg, params, img, a1, *args)
    f0, _, _, _ = custom_clip.apply(cfg, params, img, a0, *args)
    assert float(jnp.abs(f1 - f0).max()) > 1e-6


def test_cascade_end_to_end(tiny_cascade):
    cfg, model, params, args = tiny_cascade
    probs, pred, score = model.infer_cascade(params, *args)
    B = args[0].shape[0]
    assert probs.shape == (B, cfg.inp_size, cfg.inp_size, 1)
    assert np.all(np.asarray(probs) >= 0) and np.all(np.asarray(probs) <= 1)
    assert pred.shape == (B,) and score.shape == (B, 3)

    masks, edges = model(params, *args)
    assert masks.shape == (B, cfg.inp_size, cfg.inp_size, 1)
    assert edges.shape == (B, cfg.inp_size, cfg.inp_size, 1)


@pytest.mark.slow  # ~30s double-compile; determinism also pinned by seeded-loader tests
def test_cascade_jit_deterministic(tiny_cascade):
    cfg, model, params, args = tiny_cascade
    f = jax.jit(model.infer_cascade)
    p1 = f(params, *args)
    p2 = f(params, *args)
    np.testing.assert_array_equal(np.asarray(p1[0]), np.asarray(p2[0]))


def test_encoder_attn_impls_agree():
    """'flash' (rel@sel path) == 'aug_xla' == 'reference' dense bias
    through the full tiny encoder (windowed + global blocks)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 64, 64, 3)), jnp.float32)
    outs = {}
    params = None
    for impl in ("reference", "flash", "aug_xla"):
        cfg = SamEncoderConfig.tiny(attn_impl=impl)
        if params is None:
            params = sam_encoder.init(cfg, jax.random.PRNGKey(0))
            params = jax.tree.map(
                lambda p: p + 0.01 * np.random.default_rng(1).standard_normal(p.shape).astype(p.dtype),
                params,
            )
        outs[impl] = np.asarray(sam_encoder.apply(cfg, params, x))
    np.testing.assert_allclose(outs["flash"], outs["reference"], atol=1e-4)
    np.testing.assert_allclose(outs["aug_xla"], outs["reference"], atol=1e-4)
