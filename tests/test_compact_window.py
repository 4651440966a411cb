"""Compact (pad-free) window layout: partition round-trip, the analytic
virtual-pad-key edge attention vs a literal padded-window oracle, and the
compact encoder path vs the dense 'reference' implementation.

Reference semantics under test: the reference LNs the unpadded grid, then
zero-pads to a window multiple (`image_encoder.py:433-446`), so pad tokens
enter attention with k/v equal to the qkv bias; outputs at pad positions are
cropped. The compact layout reproduces this without materialising pad rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from camouflaged_vlm_tpu.models import sam_encoder
from camouflaged_vlm_tpu.models.sam_encoder import SamEncoderConfig, make_rcomb
from camouflaged_vlm_tpu.ops.compact_window import (
    REL_LANES,
    CompactGeometry,
    compact_partition,
    compact_unpartition,
    edge_attention_literal,
    edge_consts,
    edge_rel_lpad,
)
from camouflaged_vlm_tpu.ops.attention import qkv_packed_edge


def test_geometry_vith():
    g = CompactGeometry(64, 64, 14)
    assert (g.nh, g.nw, g.rb, g.rw) == (4, 4, 8, 8)
    assert g.n_full == 16
    # 4 right + 4 bottom (112 real rows) + corner (64 real, padded to 112)
    assert (g.n_edge, g.R_u, g.E) == (9, 112, 1008)
    assert [grp.rows for grp in g.edge_groups] == [112, 112, 64]


@pytest.mark.parametrize("H,W,win", [(64, 64, 14), (5, 5, 2), (7, 5, 3), (4, 4, 2)])
def test_partition_roundtrip(H, W, win):
    g = CompactGeometry(H, W, win)
    x = jnp.asarray(np.random.RandomState(0).randn(2, H, W, 6), jnp.float32)
    xf, xe = compact_partition(x, g)
    assert xf.shape == (2 * g.n_full, win * win, 6)
    if g.has_edge:
        assert xe.shape == (2, g.E, 6)
    else:
        assert xe is None
    np.testing.assert_array_equal(compact_unpartition(xf, xe, g), x)


def _real_row_mask(g):
    """(E,) bool: real (non-dummy) rows of the uniform edge layout."""
    m = np.zeros((g.n_edge, g.R_u), bool)
    off = 0
    for grp in g.edge_groups:
        m[off : off + grp.n, : grp.rows] = True
        off += grp.n
    return m.reshape(-1)


@pytest.mark.parametrize("H,W,win", [(64, 64, 14), (5, 5, 2), (7, 5, 3)])
def test_edge_attention_analytic_vs_literal(H, W, win):
    """The virtual-pad-key factorisation must equal literally
    materialising the padded window with bias-valued pad k/v rows."""
    g = CompactGeometry(H, W, win)
    heads, hd = 4, 8
    dim = heads * hd
    scale = hd ** -0.5
    rng = np.random.RandomState(1)
    B = 2
    qkv_e = jnp.asarray(rng.randn(B, g.E, 3 * dim), jnp.float32)
    bias = jnp.asarray(rng.randn(3 * dim), jnp.float32)
    rel_h = jnp.asarray(0.5 * rng.randn(2 * win - 1, hd), jnp.float32)
    rel_w = jnp.asarray(0.5 * rng.randn(2 * win - 1, hd), jnp.float32)

    want = edge_attention_literal(qkv_e, bias, rel_h, rel_w, scale, heads, g)

    q_e = qkv_e[:, :, :dim].reshape(B, g.E, heads, hd)
    rcomb = make_rcomb(win, win, rel_h, rel_w, jnp.float32)
    rel_e = edge_rel_lpad(
        q_e, rcomb, bias[dim : 2 * dim].reshape(heads, hd), scale, g
    )
    sel, kmask = edge_consts(g, jnp.float32)
    got = qkv_packed_edge(
        qkv_e.reshape(B, g.n_edge, g.R_u, 3 * dim),
        rel_e.reshape(B, g.n_edge, g.R_u, heads * REL_LANES),
        sel, bias[2 * dim :].reshape(heads, hd),
        kmask, scale, heads, hd,
    )  # (B, n, heads*hd, R) d-major -> head-leading rows for comparison
    got = (
        got.reshape(B, g.n_edge, heads, hd, g.R_u)
        .transpose(0, 2, 1, 4, 3)
        .reshape(B, heads, g.E, hd)
    )
    real = _real_row_mask(g)
    np.testing.assert_allclose(
        np.asarray(got)[:, :, real], np.asarray(want)[:, :, real], atol=2e-5
    )


@pytest.mark.parametrize("img", [64, 80])
def test_compact_encoder_matches_reference_impl(img):
    """Tiny encoder with 8 heads (the fused path's head count), fp32:
    attn_impl='flash' (compact layout) vs attn_impl='reference' (dense
    bias, padded windows). img=80 -> grid 5, window 2: grid % window != 0
    exercises the edge-window path end to end."""
    kw = dict(img_size=img, num_heads=8, gelu_approximate=False, dtype=jnp.float32)
    cfg_f = SamEncoderConfig.tiny(attn_impl="flash", **kw)
    cfg_r = SamEncoderConfig.tiny(attn_impl="reference", **kw)
    x = jnp.asarray(np.random.RandomState(2).randn(2, img, img, 3), jnp.float32)
    params = sam_encoder.init(cfg_f, jax.random.PRNGKey(0))
    y_f = sam_encoder.apply(cfg_f, params, x)
    y_r = sam_encoder.apply(cfg_r, params, x)
    np.testing.assert_allclose(np.asarray(y_f), np.asarray(y_r), atol=2e-4)


@pytest.mark.slow  # ~35s; kernel backward equality stays fast in test_attention_impls
def test_compact_encoder_grads_flow():
    """The trainable prompt generator must receive gradients through the
    compact path (custom-VJP kernels included)."""
    cfg = SamEncoderConfig.tiny(attn_impl="flash", img_size=80, num_heads=8,
                                dtype=jnp.float32)
    x = jnp.asarray(np.random.RandomState(3).randn(1, 80, 80, 3), jnp.float32)
    params = sam_encoder.init(cfg, jax.random.PRNGKey(0))

    def loss(p):
        return jnp.sum(sam_encoder.apply(cfg, p, x) ** 2)

    grads = jax.grad(loss)(params)
    g = grads["prompt_generator"]["shared_mlp"]["kernel"]
    assert float(jnp.abs(g).max()) > 0.0
