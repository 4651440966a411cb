"""The precomputed rel-table cache ('relcache' collection) must be a pure
hoist: cascade outputs with `attach_rel_cache` == outputs without, bitwise
(same einsums, same table values — only WHERE the tables are built moves).
See models/sam_encoder.py::precompute_rel_tables."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from camouflaged_vlm_tpu.factory import (
    attach_rel_cache,
    build_tiny_cascade,
    init_cascade_params,
    make_bank_inputs,
    make_example_inputs,
)

CLASSNAMES = ["cat", "owl", "snow leopard", "scorpionfish"]


@pytest.mark.slow  # ~2 min bitwise-equality pass (fast tier keeps the edge-window hoist check)
def test_rel_cache_is_pure_hoist():
    model, cfg = build_tiny_cascade()
    bank = make_bank_inputs(cfg, CLASSNAMES)
    params = init_cascade_params(model)
    inp, cimg, cmask = make_example_inputs(cfg, batch=2, seed=3)

    args = (inp, cimg, cmask, bank["prefix"], bank["suffix"],
            bank["eot_indices"], bank["bank_features"])
    run = jax.jit(lambda p: model.infer_cascade(p, *args))
    probs0, pred0, score0 = run(params)

    cached = attach_rel_cache(params, cfg)
    assert "relcache" in cached and "image_encoder" in cached["relcache"]
    # every windowed block carries rblk+rcomb, global blocks rcg
    enc_cache = cached["relcache"]["image_encoder"]
    assert len(enc_cache) == cfg.encoder.depth
    probs1, pred1, score1 = jax.jit(lambda p: model.infer_cascade(p, *args))(cached)

    np.testing.assert_array_equal(np.asarray(pred0), np.asarray(pred1))
    np.testing.assert_allclose(
        np.asarray(probs0, np.float32), np.asarray(probs1, np.float32),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(score0, np.float32), np.asarray(score1, np.float32),
        atol=1e-6,
    )


def test_rel_cache_edge_windows_hoist():
    """grid % window != 0 (img 80, patch 16 -> grid 5, window 2): the edge
    windows take the `edge_rel_fast` hoisted-table path, whose rel + Lpad
    must match the in-program `edge_rel_lpad` build (dot-based logsumexp is
    exact up to f32 rounding)."""
    from camouflaged_vlm_tpu.models import sam_encoder
    from camouflaged_vlm_tpu.models.sam_encoder import (
        SamEncoderConfig, precompute_rel_tables,
    )

    cfg = SamEncoderConfig(
        img_size=80, patch_size=16, embed_dim=64, depth=4, num_heads=8,
        mlp_ratio=4.0, out_chans=32, window_size=2,
        global_attn_indexes=(1, 3), prompt_scale_factor=32,
        attn_impl="flash", gelu_approximate=False,
    )
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 80, 80, 3)), jnp.float32
    )
    params = sam_encoder.init(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(  # non-zero rel tables, so the hoist matters
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(1), p.shape),
        params,
    )
    y0 = jax.jit(lambda p, x: sam_encoder.apply(cfg, p, x))(params, x)

    cache = precompute_rel_tables(cfg, params)
    # grid 5 % win 2 != 0 -> every windowed block must carry edge tables
    assert any("redge_0" in v["attn"] for v in cache.values())
    y1 = jax.jit(lambda p, x, c: sam_encoder.apply(cfg, p, x, relcache=c))(
        params, x, cache
    )
    np.testing.assert_allclose(
        np.asarray(y0, np.float32), np.asarray(y1, np.float32), atol=2e-5
    )
