"""Equivalence of the attention formulations: the dense decomposed-bias
reference vs augmented features, the `rel @ sel` XLA formulations on the
packed qkv layout, and the Pallas-Triton global-attention kernel (Pallas
interpreter on the CPU; compiled on the GPU under the `gpu` marker)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from camouflaged_vlm_tpu.ops.rel_pos import attention_with_decomposed_rel_pos
from camouflaged_vlm_tpu.ops.aug_attention import augment_qk, attention_xla
from camouflaged_vlm_tpu.ops import attention as fa


@pytest.mark.parametrize("H,W", [(4, 4), (3, 5)])
def test_augmented_equals_reference(rng, H, W):
    B, d = 3, 16
    n = H * W
    q = rng.standard_normal((B, n, d)).astype(np.float32)
    k = rng.standard_normal((B, n, d)).astype(np.float32)
    v = rng.standard_normal((B, n, d)).astype(np.float32)
    rel_h = (rng.standard_normal((2 * H - 1, d)) * 0.1).astype(np.float32)
    rel_w = (rng.standard_normal((2 * W - 1, d)) * 0.1).astype(np.float32)
    scale = d ** -0.5

    want = attention_with_decomposed_rel_pos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(rel_h), jnp.asarray(rel_w), (H, W), scale,
    )
    q_aug, k_aug = augment_qk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(rel_h), jnp.asarray(rel_w),
        (H, W), scale,
    )
    assert q_aug.shape[-1] % 128 == 0
    got = attention_xla(q_aug, k_aug, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


def test_augmented_no_rel_pos(rng):
    B, n, d = 2, 8, 4
    q = rng.standard_normal((B, n, d)).astype(np.float32)
    k = rng.standard_normal((B, n, d)).astype(np.float32)
    v = rng.standard_normal((B, n, d)).astype(np.float32)
    scale = d ** -0.5
    want = attention_with_decomposed_rel_pos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, (2, 4), scale
    )
    q_aug, k_aug = augment_qk(jnp.asarray(q), jnp.asarray(k), None, None, (2, 4), scale)
    got = attention_xla(q_aug, k_aug, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("H,W", [(4, 4), (3, 5)])
def test_xla_relpos_equals_reference(rng, H, W):
    """rel@sel scatter formulation == dense decomposed-bias attention."""
    from camouflaged_vlm_tpu.ops.attention import (
        make_rel_scatter,
        xla_attention_relpos,
    )
    from camouflaged_vlm_tpu.ops.rel_pos import get_rel_pos_table

    B, heads, d = 2, 2, 16
    n = H * W
    q = rng.standard_normal((B, heads, n, d)).astype(np.float32)
    k = rng.standard_normal((B, heads, n, d)).astype(np.float32)
    v = rng.standard_normal((B, heads, n, d)).astype(np.float32)
    rel_h = (rng.standard_normal((2 * H - 1, d)) * 0.1).astype(np.float32)
    rel_w = (rng.standard_normal((2 * W - 1, d)) * 0.1).astype(np.float32)
    scale = d ** -0.5

    want = attention_with_decomposed_rel_pos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(rel_h), jnp.asarray(rel_w), (H, W), scale,
    )

    Rh = get_rel_pos_table(H, H, jnp.asarray(rel_h))
    Rw = get_rel_pos_table(W, W, jnp.asarray(rel_w))
    rq = jnp.asarray(q).reshape(B, heads, H, W, d)
    rh = jnp.einsum("bnhwc,hkc->bnhwk", rq, Rh).reshape(B, heads, n, H)
    rw = jnp.einsum("bnhwc,wkc->bnhwk", rq, Rw).reshape(B, heads, n, W)
    rel = jnp.concatenate([rh, rw], axis=-1)
    sel = make_rel_scatter(H, W, dtype=jnp.float32)
    got = xla_attention_relpos(jnp.asarray(q) * scale, jnp.asarray(k), jnp.asarray(v), rel, sel)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)




def _dense_oracle(qkv, rel, heads, d, scale, H, W):
    """Straightforward float32 rel-pos attention on the packed layout:
    qkv (..., N, 3*heads*d), rel (..., N, heads*L) with lanes [rel_h (H) |
    rel_w (W) | pad]; bias[q, k] = rel_h[q, k // W] + rel_w[q, k % W],
    gathered by index (no scatter matrix). Returns rows (..., N, heads*d)."""
    *lead, N, _ = qkv.shape
    qkv = jnp.asarray(qkv, jnp.float32)
    r = qkv.reshape(*lead, N, 3, heads, d)
    q, k, v = (jnp.moveaxis(r[..., i, :, :], -2, -3) for i in range(3))
    relh = jnp.moveaxis(jnp.asarray(rel, jnp.float32).reshape(*lead, N, heads, -1), -2, -3)
    kk = np.arange(N)
    bias = relh[..., kk // W] + relh[..., H + kk % W]  # (..., heads, N, N)
    with jax.default_matmul_precision("highest"):
        s = jnp.einsum("...qc,...kc->...qk", q * scale, k) + bias
        o = jnp.einsum("...qk,...kc->...qc", jax.nn.softmax(s, axis=-1), v)
    return jnp.moveaxis(o, -3, -2).reshape(*lead, N, heads * d)


def _rows(d_major, heads, d):
    """(..., heads*d, S) d-major -> rows (..., S, heads*d)."""
    *lead, _, S = d_major.shape
    return jnp.swapaxes(d_major, -1, -2).reshape(*lead, S, heads * d)


@pytest.mark.parametrize("heads,nwin", [(2, 2), (4, 2)])
def test_flash_qkv_windows_matches_oracle(rng, heads, nwin):
    """qkv_relpos_windows (5D head view, windows whose H+W exceeds the
    32-lane packing) == the dense oracle."""
    H = W = 4
    B, d = 2, 32
    N = H * W
    qkv = rng.standard_normal((B, nwin, N, 3 * heads * d)).astype(np.float32) * 0.3
    rel = (rng.standard_normal((B, nwin, N, heads * (H + W))) * 0.1).astype(np.float32)
    sel = fa.make_rel_scatter(H, W, dtype=jnp.float32)
    scale = d ** -0.5
    got = fa.qkv_relpos_windows(
        jnp.asarray(qkv).reshape(B, nwin, N, 3 * heads, d),
        jnp.asarray(rel).reshape(B, nwin, N, heads, H + W),
        sel, scale,
    )  # (B, heads, nwin, N, d)
    got = jnp.moveaxis(got, 1, 3).reshape(B, nwin, N, heads * d)
    want = _dense_oracle(qkv, rel, heads, d, scale, H, W)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("heads,nwin", [(2, 2), (4, 2)])
def test_flash_qkv_packed_windows_matches_oracle(rng, heads, nwin):
    """Packed-lane windows (raw 3*heads*d layout, rel padded to 32
    lanes/head) -> d-major output == the dense oracle."""
    H = W = 4
    B, d = 2, 80
    N = H * W
    hw = H + W
    qkv = rng.standard_normal((B, nwin, N, 3 * heads * d)).astype(np.float32) * 0.3
    rel = (rng.standard_normal((B, nwin, N, heads, hw)) * 0.1).astype(np.float32)
    sel = fa.make_rel_scatter(H, W, dtype=jnp.float32)
    scale = d ** -0.5
    rel_p = jnp.pad(jnp.asarray(rel), ((0, 0),) * 4 + ((0, 32 - hw),))
    sel32 = jnp.pad(sel, ((0, 32 - hw), (0, 0)))
    got = fa.qkv_packed_windows(
        jnp.asarray(qkv), rel_p.reshape(B, nwin, N, heads * 32), sel32,
        scale, heads, d,
    )  # (B, nwin, heads*d, N) — d-major
    want = _dense_oracle(qkv, rel_p.reshape(B, nwin, N, heads * 32), heads, d, scale, H, W)
    np.testing.assert_allclose(np.asarray(_rows(got, heads, d)), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("heads,head_group", [(2, 2), (4, 2)])
def test_flash_qkv_packed_windows_s_matches_oracle(rng, heads, head_group):
    """Position-major rel windows (the (N, BW, heads*32) layout
    `rel_smajor_windows` emits, here built with a `head_group`-blocked
    kron table) == the dense oracle."""
    from camouflaged_vlm_tpu.models.sam_encoder import make_rblk, rel_smajor_windows

    win, d = 4, 16
    BW, N = 6, win * win
    qkv = jnp.asarray(rng.standard_normal((BW, N, 3 * heads * d)) * 0.3, jnp.float32)
    rph = jnp.asarray(rng.standard_normal((2 * win - 1, d)) * 0.3, jnp.float32)
    rpw = jnp.asarray(rng.standard_normal((2 * win - 1, d)) * 0.3, jnp.float32)
    rblk = make_rblk(win, rph, rpw, d, jnp.float32, head_group=head_group)
    rel_s, sel32 = rel_smajor_windows(
        qkv, rph, rpw, win, heads, d, head_group=head_group, rblk=rblk
    )
    scale = d ** -0.5
    got = fa.qkv_packed_windows_s(qkv, rel_s, sel32, scale, heads, d)
    rel_rows = rel_s.transpose(1, 0, 2)  # (BW, N, heads*32)
    want = _dense_oracle(qkv, rel_rows, heads, d, scale, win, win)
    np.testing.assert_allclose(np.asarray(_rows(got, heads, d)), np.asarray(want), atol=2e-5)
    # and the rel factors are the decomposed bias of the reference
    q = qkv[:, :, : heads * d].reshape(BW, N, heads, d).transpose(0, 2, 1, 3)
    k = qkv[:, :, heads * d : 2 * heads * d].reshape(BW, N, heads, d).transpose(0, 2, 1, 3)
    v = qkv[:, :, 2 * heads * d :].reshape(BW, N, heads, d).transpose(0, 2, 1, 3)
    with jax.default_matmul_precision("highest"):
        ref = attention_with_decomposed_rel_pos(q, k, v, rph, rpw, (win, win), scale)
    np.testing.assert_allclose(
        np.asarray(_rows(got, heads, d)),
        np.asarray(ref.transpose(0, 2, 1, 3).reshape(BW, N, heads * d)),
        atol=2e-5,
    )


def test_rel_smajor_windows_matches_rel_packed32(rng):
    """The kron-table s-major rel builder emits the SAME per-head packed
    factors as rel_packed32, transposed to position-major."""
    from camouflaged_vlm_tpu.models.sam_encoder import (
        rel_packed32, rel_smajor_windows,
    )

    win, heads, hd = 4, 4, 16
    BW, S = 6, win * win
    qkv = jnp.asarray(
        rng.standard_normal((BW, S, 3 * heads * hd)).astype(np.float32)
    )
    rph = jnp.asarray((rng.standard_normal((2 * win - 1, hd)) * 0.1).astype(np.float32))
    rpw = jnp.asarray((rng.standard_normal((2 * win - 1, hd)) * 0.1).astype(np.float32))
    qh = qkv[:, :, : heads * hd].reshape(BW, win, win, heads, hd)
    want, sel32_w = rel_packed32(qh, rph, rpw, win, win)
    want = want.reshape(BW, S, heads * 32).transpose(1, 0, 2)
    got, sel32 = rel_smajor_windows(qkv, rph, rpw, win, heads, hd, head_group=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sel32), np.asarray(sel32_w))


@pytest.mark.parametrize("heads,head_group", [(2, 2), (4, 2)])
def test_flash_qkv_packed_plain_matches_oracle(rng, heads, head_group):
    """Plain packed-qkv attention (CLIP path) == standard attention, also
    when the heads are split into `head_group`-sized calls."""
    B, L, d = 2, 37, 64  # odd L like CLIP's 581
    qkv = rng.standard_normal((B, L, 3 * heads * d)).astype(np.float32) * 0.3
    scale = d ** -0.5
    got = fa.qkv_packed_plain(jnp.asarray(qkv), scale, heads, d)
    got = got.reshape(B, heads, d, L).transpose(0, 1, 3, 2)

    def split(i):
        t = qkv[..., i * heads * d : (i + 1) * heads * d].reshape(B, L, heads, d)
        return jnp.moveaxis(jnp.asarray(t), 1, 2)
    q, k, v = split(0), split(1), split(2)
    with jax.default_matmul_precision("highest"):
        s = jnp.einsum("bhqc,bhkc->bhqk", q * scale, k)
        want = jnp.einsum("bhqk,bhkc->bhqc", jax.nn.softmax(s, axis=-1), v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)
    # heads are independent: a head-group slice of the packed input gives
    # the matching slice of the output
    g = head_group
    sub = np.concatenate(
        [qkv[..., i * heads * d : i * heads * d + g * d] for i in range(3)], axis=-1
    )
    got_g = fa.qkv_packed_plain(jnp.asarray(sub), scale, g, d)
    np.testing.assert_allclose(
        np.asarray(got_g.reshape(B, g, d, L).transpose(0, 1, 3, 2)),
        np.asarray(got[:, :g]), atol=1e-6,
    )


def _global_inputs(rng, B, heads, d, H, W, rel_scale=2.0):
    N, hw = H * W, H + W
    qkv = jnp.asarray(rng.standard_normal((B, N, 3 * heads * d)) * 0.5, jnp.float32)
    rel_s = jnp.asarray(rng.standard_normal((N, B, heads, hw)) * rel_scale, jnp.float32)
    return qkv, rel_s


@pytest.mark.parametrize("heads,head_group", [(2, 2), (4, 2)])
def test_flash_qkv_packed_global_matches_oracle(rng, heads, head_group):
    """qkv_packed_global (the XLA formulation off CUDA) -> rows == the dense
    oracle, for the whole head set and for a head-group subset."""
    H = W = 8
    B, d = 2, 8
    qkv, rel_s = _global_inputs(rng, B, heads, d, H, W, rel_scale=0.1)
    scale = d ** -0.5
    got = fa.qkv_packed_global(qkv, rel_s, scale, heads, d, H, W)
    want = _dense_oracle(qkv, rel_s.transpose(1, 0, 2, 3).reshape(B, H * W, -1),
                         heads, d, scale, H, W)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)
    g = head_group
    sub = jnp.concatenate(
        [qkv[..., i * heads * d : i * heads * d + g * d] for i in range(3)], axis=-1
    )
    got_g = fa.qkv_packed_global(sub, rel_s[:, :, :g], scale, g, d, H, W)
    np.testing.assert_allclose(np.asarray(got_g), np.asarray(got[..., : g * d]), atol=1e-6)


@pytest.mark.parametrize(
    "B,heads,d,H,W,block_q",
    [
        (2, 2, 80, 8, 8, 16),   # ViT-H head width: masked 80-of-128 slices
        (1, 3, 32, 4, 8, 8),    # H != W, odd head count, unmasked width
        (2, 2, 80, 16, 16, 64), # several q tiles, 16 key-row iterations
    ],
)
def test_global_triton_kernel_interpret(rng, B, heads, d, H, W, block_q):
    """The Pallas-Triton global kernel (Pallas interpreter) == the dense
    oracle: online softmax over key rows, in-register bias, masked head
    slices read straight from the packed qkv."""
    from camouflaged_vlm_tpu.ops.global_attention_triton import global_attention_triton

    qkv, rel_s = _global_inputs(rng, B, heads, d, H, W)
    scale = d ** -0.5
    got = global_attention_triton(
        qkv, rel_s, scale, heads, d, H, W, block_q=block_q, interpret=True
    )
    want = _dense_oracle(qkv, rel_s.transpose(1, 0, 2, 3).reshape(B, H * W, -1),
                         heads, d, scale, H, W)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


def test_global_triton_grad_matches_xla_grad(rng):
    """The kernel's gradient rule (the XLA formulation's VJP via
    `pallas_with_xla_vjp`) == autodiff of the XLA formulation, for qkv and
    the position-major rel; the forward matches too."""
    from camouflaged_vlm_tpu.ops.global_attention_triton import global_attention_triton
    from camouflaged_vlm_tpu.ops.vjp import pallas_with_xla_vjp

    H = W = 8
    B, heads, d = 2, 2, 80
    qkv, rel_s = _global_inputs(rng, B, heads, d, H, W)
    scale = d ** -0.5
    w = jnp.asarray(rng.standard_normal((B, H * W, heads * d)), jnp.float32)

    def xla(qkv, rel):
        return fa.qkv_packed_global_xla(qkv, rel, scale, heads, d, H, W)

    kernel = pallas_with_xla_vjp(
        lambda qkv, rel: global_attention_triton(
            qkv, rel, scale, heads, d, H, W, interpret=True), xla)

    def loss(f):
        return lambda qkv, rel: jnp.sum(w * f(qkv, rel))

    v_k, g_k = jax.value_and_grad(loss(kernel), (0, 1))(qkv, rel_s)
    v_x, g_x = jax.value_and_grad(loss(xla), (0, 1))(qkv, rel_s)
    np.testing.assert_allclose(float(v_k), float(v_x), rtol=1e-5)
    for a, b in zip(g_k, g_x):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("qkv_spec", [("data",), ("data", None, "model")])
def test_global_kernel_batch_partitioned_on_mesh(rng, qkv_spec):
    """Under a 2 x 2 (data, model) mesh the batch-partitioned kernel
    (Pallas interpreter) runs on each device's batch shard: no program
    value holds the global batch of 4, and the result is the one-device
    result. qkv sharded along its channels too is gathered only there."""
    import functools

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from camouflaged_vlm_tpu.ops.global_attention_triton import global_attention_triton

    H = W = 8
    B, heads, d = 4, 2, 80
    qkv, rel_s = _global_inputs(rng, B, heads, d, H, W)
    kernel = functools.partial(global_attention_triton, scale=d ** -0.5, heads=heads,
                               d=d, H=H, W=W, block_q=16, interpret=True)
    want = kernel(qkv, rel_s)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    f = jax.jit(fa.batch_partitioned(kernel),
                in_shardings=(NamedSharding(mesh, P(*qkv_spec)),
                              NamedSharding(mesh, P(None, "data"))),
                out_shardings=NamedSharding(mesh, P("data")))
    hlo = f.lower(qkv, rel_s).compile().as_text()
    assert f"[{B},{H * W}," not in hlo and f"[{H * W},{B}," not in hlo
    np.testing.assert_allclose(np.asarray(f(qkv, rel_s)), np.asarray(want), atol=1e-6)


@pytest.mark.gpu
def test_global_triton_kernel_on_gpu(gpu_device):
    """The compiled Triton kernel on the card, at ViT-H widths (4096 tokens,
    16 heads, d = 80), bf16 inputs, against both float32 references of
    chip_smoke.py's phase 2, on the same inputs and within the same
    derived bounds."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with jax.default_device(gpu_device):
        for name, (err, bound) in smoke.kernel_errors(1, 0.3).items():
            assert err <= bound, (name, err, bound)


def test_rel_packed32_equals_rel_and_scatter(rng):
    """Combined-table single-einsum rel == two-einsum+concat+pad rel."""
    from camouflaged_vlm_tpu.models.sam_encoder import rel_and_scatter, rel_packed32

    H, W, heads, d = 14, 14, 3, 16
    q = jnp.asarray(rng.standard_normal((2, H, W, heads, d)), jnp.float32)
    rel_h = jnp.asarray(rng.standard_normal((2 * H - 1, d)) * 0.1, jnp.float32)
    rel_w = jnp.asarray(rng.standard_normal((2 * W - 1, d)) * 0.1, jnp.float32)

    rel, sel = rel_and_scatter(q, rel_h, rel_w, H, W)
    want_rel = jnp.pad(rel, ((0, 0),) * 4 + ((0, 32 - (H + W)),))
    want_sel = jnp.pad(sel, ((0, 32 - (H + W)), (0, 0)))
    got_rel, got_sel = rel_packed32(q, rel_h, rel_w, H, W)
    np.testing.assert_allclose(np.asarray(got_rel), np.asarray(want_rel), atol=2e-5)
    np.testing.assert_array_equal(np.asarray(got_sel), np.asarray(want_sel))


def test_kernels_differentiable_match_xla_grad(rng):
    """Training differentiates through every encoder block: gradients of the
    packed windowed attention (qkv and rel) == gradients of the dense
    oracle."""
    H = W = 4
    B, nwin, heads, d = 1, 2, 2, 32
    Nn = H * W
    hw = H + W
    qkv = jnp.asarray(rng.standard_normal((B, nwin, Nn, 3 * heads * d)) * 0.3, jnp.float32)
    rel = jnp.asarray(rng.standard_normal((B, nwin, Nn, heads, hw)) * 0.1, jnp.float32)
    sel = fa.make_rel_scatter(H, W, dtype=jnp.float32)
    rel_p = jnp.pad(rel, ((0, 0),) * 4 + ((0, 32 - hw),)).reshape(B, nwin, Nn, heads * 32)
    sel32 = jnp.pad(sel, ((0, 32 - hw), (0, 0)))
    scale = d ** -0.5

    def f(qkv, rel_p):
        out = fa.qkv_packed_windows(qkv, rel_p, sel32, scale, heads, d)
        return jnp.sum(_rows(out, heads, d) ** 2)

    def g(qkv, rel_p):
        return jnp.sum(_dense_oracle(qkv, rel_p, heads, d, scale, H, W) ** 2)

    got = jax.grad(f, (0, 1))(qkv, rel_p)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(g, (0, 1))(qkv, rel_p)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=3e-4, atol=3e-4)


def test_ln_mask_linear_and_proj_res_kernels(rng):
    """The block-fusion steps: (LN(x)*mask)@w+b, LN+MLP+residual and the
    head-leading projection + residual."""
    from camouflaged_vlm_tpu.ops import linear as lin

    # ln_mask_linear_bt: B'=B*nwin rows with per-window mask
    B0, nwin, S, K, N = 2, 3, 16, 32, 64
    x = jnp.asarray(rng.standard_normal((B0 * nwin, S, K)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((1, K)) * 0.1 + 1, jnp.float32)
    be = jnp.asarray(rng.standard_normal((1, K)) * 0.1, jnp.float32)
    mask = jnp.asarray((rng.random((nwin, S, 1)) > 0.3).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((K, N)) * 0.1, jnp.float32)
    b = jnp.asarray(rng.standard_normal((1, N)), jnp.float32)
    got = lin.ln_mask_linear_bt(x, g, be, mask, w, b, eps=1e-6)

    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    xn = (x - mu) * jax.lax.rsqrt(var + 1e-6) * g + be
    m_full = jnp.tile(mask, (B0, 1, 1))
    want = (xn * m_full) @ w + b
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)

    # ln_mlp_residual_bt: whole MLP half of the block
    H = 4 * K
    w1 = jnp.asarray(rng.standard_normal((K, H)) * 0.1, jnp.float32)
    b1 = jnp.asarray(rng.standard_normal((1, H)), jnp.float32)
    w2 = jnp.asarray(rng.standard_normal((H, K)) * 0.1, jnp.float32)
    b2 = jnp.asarray(rng.standard_normal((1, K)), jnp.float32)
    got = lin.ln_mlp_residual_bt(
        x, g, be, w1, b1, w2, b2, eps=1e-6, activation="gelu_tanh"
    )
    h = jax.nn.gelu(xn @ w1 + b1, approximate=True)
    want = h @ w2 + b2 + x
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-4)

    # proj_from_heads with the residual
    B, heads, T, Sq, d, out = 2, 2, 3, 16, 8, 32
    x5 = jnp.asarray(rng.standard_normal((B, heads, T, Sq, d)), jnp.float32)
    wp = jnp.asarray(rng.standard_normal((heads, d, out)) * 0.1, jnp.float32)
    bp = jnp.asarray(rng.standard_normal((1, out)), jnp.float32)
    res = jnp.asarray(rng.standard_normal((B, T, Sq, out)), jnp.float32)
    got = lin.proj_from_heads(x5, wp, bp, res)
    want = jnp.einsum("bhtsd,hdo->btso", x5, wp) + bp + res
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


def test_only_the_triton_pallas_dialect_is_imported():
    """Every Pallas dialect that a module, script or test imports is the
    Triton one: `jax.experimental.pallas` itself, or `.triton` under it."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    pat = re.compile(r"pallas(?:\.|\s+import\s+)(\w+)")
    hits = {
        f"{p.relative_to(root)}: {m}"
        for p in root.rglob("*.py")
        for m in pat.findall(p.read_text())
        if m != "triton"
    }
    assert not hits, sorted(hits)
