"""Unit tests for core ops against torch-CPU oracles (tests only — the
framework itself never imports torch on the compute path)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from camouflaged_vlm_tpu.ops import (
    layer_norm,
    window_partition,
    window_unpartition,
    get_rel_pos_table,
    attention_with_decomposed_rel_pos,
    fft_highpass,
    resize_bilinear,
    max_pool_2d,
    morphological_edge,
)


def test_layer_norm_matches_torch(rng):
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    scale = rng.standard_normal(5).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    got = layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps=1e-6)
    want = F.layer_norm(
        torch.from_numpy(x), (5,), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6
    ).numpy()
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_window_roundtrip(rng):
    x = rng.standard_normal((2, 10, 10, 3)).astype(np.float32)
    win, pad_hw = window_partition(jnp.asarray(x), 4)
    assert win.shape == (2 * 3 * 3, 4, 4, 3)
    assert pad_hw == (12, 12)
    back = window_unpartition(win, 4, pad_hw, (10, 10))
    np.testing.assert_array_equal(np.asarray(back), x)


def test_window_partition_matches_torch_semantics(rng):
    # Padded region must be zeros placed bottom/right, windows ordered row-major.
    x = rng.standard_normal((1, 5, 5, 2)).astype(np.float32)
    win, (hp, wp) = window_partition(jnp.asarray(x), 3)
    assert (hp, wp) == (6, 6)
    w = np.asarray(win).reshape(1, 2, 2, 3, 3, 2)
    np.testing.assert_array_equal(w[0, 0, 0], x[0, 0:3, 0:3])
    np.testing.assert_array_equal(w[0, 1, 1, 2], np.zeros((3, 2), np.float32))


def _torch_rel_pos_attention(q, k, v, rel_h_table, rel_w_table, H, W, scale):
    """Oracle re-derivation of ViTDet decomposed rel-pos attention."""
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    attn = (qt * scale) @ kt.transpose(-2, -1)
    B = q.shape[0]
    rq = qt.reshape(B, H, W, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, torch.from_numpy(rel_h_table))
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, torch.from_numpy(rel_w_table))
    attn = (
        attn.view(B, H, W, H, W) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    ).view(B, H * W, H * W)
    attn = attn.softmax(dim=-1)
    return (attn @ vt).numpy()


def test_rel_pos_table_identity_case():
    table = np.arange(9 * 4, dtype=np.float32).reshape(9, 4)  # 2*5-1 entries
    got = np.asarray(get_rel_pos_table(5, 5, jnp.asarray(table)))
    # q=i, k=j -> index i - j + 4
    for i in range(5):
        for j in range(5):
            np.testing.assert_array_equal(got[i, j], table[i - j + 4])


@pytest.mark.parametrize("H,W", [(4, 4), (3, 5)])
def test_attention_with_rel_pos_matches_oracle(rng, H, W):
    B, d = 2, 8
    n = H * W
    q = rng.standard_normal((B, n, d)).astype(np.float32)
    k = rng.standard_normal((B, n, d)).astype(np.float32)
    v = rng.standard_normal((B, n, d)).astype(np.float32)
    rel_h = rng.standard_normal((2 * H - 1, d)).astype(np.float32) * 0.1
    rel_w = rng.standard_normal((2 * W - 1, d)).astype(np.float32) * 0.1
    scale = d ** -0.5

    got = attention_with_decomposed_rel_pos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(rel_h), jnp.asarray(rel_w), (H, W), scale,
    )
    rel_h_t = np.asarray(get_rel_pos_table(H, H, jnp.asarray(rel_h)))
    rel_w_t = np.asarray(get_rel_pos_table(W, W, jnp.asarray(rel_w)))
    want = _torch_rel_pos_attention(q, k, v, rel_h_t, rel_w_t, H, W, scale)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)


def test_attention_no_rel_pos_is_plain_softmax_attention(rng):
    B, n, d = 1, 6, 4
    q = rng.standard_normal((B, n, d)).astype(np.float32)
    k = rng.standard_normal((B, n, d)).astype(np.float32)
    v = rng.standard_normal((B, n, d)).astype(np.float32)
    got = attention_with_decomposed_rel_pos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, (2, 3), d ** -0.5
    )
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    want = (((qt * d ** -0.5) @ kt.transpose(-2, -1)).softmax(-1) @ vt).numpy()
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_fft_highpass_matches_torch(rng):
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    got = np.asarray(fft_highpass(jnp.asarray(x), 0.25))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW oracle
    w, h = 16, 16
    line = int((w * h * 0.25) ** 0.5 // 2)
    mask = torch.zeros_like(xt)
    mask[:, :, w // 2 - line : w // 2 + line, h // 2 - line : h // 2 + line] = 1
    f = torch.fft.fftshift(torch.fft.fft2(xt, norm="forward"))
    f = f * (1 - mask)
    inv = torch.fft.ifft2(torch.fft.ifftshift(f), norm="forward").real.abs()
    want = inv.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resize_bilinear_matches_torch_align_corners_false(rng):
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    got = np.asarray(resize_bilinear(jnp.asarray(x), 17, 5))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = (
        F.interpolate(xt, (17, 5), mode="bilinear", align_corners=False)
        .permute(0, 2, 3, 1)
        .numpy()
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_max_pool_and_edge_match_torch(rng):
    m = (rng.random((2, 12, 12, 1)) > 0.5).astype(np.float32)
    got_pool = np.asarray(max_pool_2d(jnp.asarray(m), 5))
    mt = torch.from_numpy(m).permute(0, 3, 1, 2)
    want_pool = F.max_pool2d(mt, 5, stride=1, padding=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_pool, want_pool)

    got_edge = np.asarray(morphological_edge(jnp.asarray(m), 5))
    eroded = -F.max_pool2d(-mt, 5, stride=1, padding=2)
    dilated = F.max_pool2d(mt, 5, stride=1, padding=2)
    want_edge = ((dilated - eroded) > 0).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_edge, want_edge)


def test_fft_highpass_matmul_matches_fft_oracle(rng):
    """Circulant-matmul formulation == direct jnp.fft path (odd/even sizes)."""
    from camouflaged_vlm_tpu.ops.fft_prompt import fft_highpass_fft

    for H, W in [(64, 64), (32, 48)]:
        x = jnp.asarray(rng.standard_normal((2, H, W, 3)), jnp.float32)
        got = np.asarray(fft_highpass(x, 0.25))
        want = np.asarray(fft_highpass_fft(x, 0.25))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_patch_embed_matmul_matches_conv(rng):
    """The encoder's patch embed (rearrange + one matmul) == a 16x16,
    stride-16 VALID convolution with the same (kh, kw, in, out) kernel."""
    import jax

    from camouflaged_vlm_tpu.models import layers as L
    from camouflaged_vlm_tpu.models.sam_encoder import patch_embed

    x = jnp.asarray(rng.standard_normal((2, 64, 48, 3)), jnp.float32)
    p = L.conv_init(jax.random.PRNGKey(0), 16, 16, 3, 32, bias=True)
    p["bias"] = jnp.asarray(rng.standard_normal(32), jnp.float32)
    got = patch_embed(p, x, 16, jnp.float32)
    with jax.default_matmul_precision("highest"):
        want = L.conv(p, x, 16, "VALID", jnp.float32)
    assert got.shape == (2, 4, 3, 32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-4)


def test_proj_from_heads_matches_dense(rng):
    """Head-leading projection == moveaxis + reshape + matmul."""
    from camouflaged_vlm_tpu.ops import linear as lin

    B, heads, T, S, d, out = 2, 4, 2, 64, 32, 96
    x = jnp.asarray(rng.standard_normal((B, heads, T, S, d)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((heads * d, out)) * 0.1, jnp.float32)
    b = jnp.asarray(rng.standard_normal((1, out)), jnp.float32)
    got = lin.proj_from_heads(x, w.reshape(heads, d, out), b)  # (B,T,S,out)
    got = got.reshape(B, T * S, out)
    xf = jnp.moveaxis(x.reshape(B, heads, T * S, d), 1, 2).reshape(B, T * S, heads * d)
    want = xf @ w + b
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-4)
