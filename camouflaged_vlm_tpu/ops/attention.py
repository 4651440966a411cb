"""Attention with the decomposed rel-pos bias, on the packed qkv layout.

The ViTDet decomposed bias has rank structure
(`bias[q, k] = rel_h[q, k // W] + rel_w[q, k % W]`,
upstream `models/mmseg/models/sam/image_encoder.py:589-625`): the
caller passes `rel = [rel_h | rel_w]` (seq x (H+W)) and the scores add
`rel @ sel`, with `sel` a constant 0/1 scatter ((H+W) x seq).

Every function here reads q/k/v as slices of the raw qkv projection
(..., 3 * heads * d) and is written as an XLA formulation. The windowed
functions return the d-major (..., heads * d, S) layout that
`ops.linear.proj_rows` consumes. `qkv_packed_global` additionally runs a
Pallas-Triton kernel on CUDA devices (`ops.global_attention_triton`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.custom_partitioning import custom_partitioning
from jax.sharding import NamedSharding, PartitionSpec as P

from .compact_window import LPAD_LANE, REL_LANES
from .global_attention_triton import global_attention_triton
from .vjp import pallas_with_xla_vjp


def make_rel_scatter(H: int, W: int, dtype=jnp.bfloat16) -> jnp.ndarray:
    """((H+W), H*W) 0/1 matrix: row a scatters rel_h[:, a] to keys with
    k//W == a (first H rows) / rel_w[:, b] to keys with k%W == b (last W).
    Built in numpy so it embeds as a literal constant in the program."""
    n = H * W
    kh = np.arange(n) // W
    kw = np.arange(n) % W
    sel_h = kh[None, :] == np.arange(H)[:, None]
    sel_w = kw[None, :] == np.arange(W)[:, None]
    return jnp.asarray(np.concatenate([sel_h, sel_w], axis=0), dtype)


def xla_attention_relpos(
    q: jnp.ndarray,    # (..., N, d) — pre-scaled
    k: jnp.ndarray,    # (..., N, d)
    v: jnp.ndarray,    # (..., N, d_v)
    rel: jnp.ndarray,  # (..., N, H+W)
    sel: jnp.ndarray,  # (H+W, N)
) -> jnp.ndarray:
    """softmax(q k^T + rel @ sel) v with float32 scores."""
    s = jnp.einsum("...qc,...kc->...qk", q, k, preferred_element_type=jnp.float32)
    s = s + jnp.einsum(
        "...qr,rk->...qk", rel, sel.astype(rel.dtype),
        preferred_element_type=jnp.float32,
    )
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum(
        "...qk,...kc->...qc", p.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    ).astype(v.dtype)


def _split_heads(qkv, heads, d, scale):
    """(..., S, 3*heads*d) -> q (pre-scaled), k, v as (..., heads, S, d)."""
    r = qkv.reshape(*qkv.shape[:-1], 3, heads, d)
    q, k, v = (jnp.moveaxis(r[..., i, :, :], -2, -3) for i in range(3))
    return q * jnp.asarray(scale, qkv.dtype), k, v


def _d_major(o):
    """(..., heads, S, d) -> (..., heads*d, S)."""
    *lead, heads, S, d = o.shape
    return jnp.swapaxes(o, -1, -2).reshape(*lead, heads * d, S)


def qkv_relpos_windows(
    qkv: jnp.ndarray,  # (B, nwin, Nw, 3*heads, d) — 5D view of the packed Dense
    rel: jnp.ndarray,  # (B, nwin, Nw, heads, H+W) — [rel_h | rel_w] per query
    sel: jnp.ndarray,  # (H+W, Nw) from make_rel_scatter
    scale: float,
) -> jnp.ndarray:
    """Windowed rel-pos attention for windows whose H+W exceeds the 32-lane
    packing. Output is head-leading (B, heads, nwin, Nw, d) for
    `proj_from_heads`."""
    heads = qkv.shape[3] // 3
    q = jnp.moveaxis(qkv[:, :, :, :heads], 3, 1) * jnp.asarray(scale, qkv.dtype)
    k = jnp.moveaxis(qkv[:, :, :, heads : 2 * heads], 3, 1)
    v = jnp.moveaxis(qkv[:, :, :, 2 * heads :], 3, 1)
    return xla_attention_relpos(q, k, v, jnp.moveaxis(rel, 3, 1), sel)


def qkv_packed_windows(
    qkv: jnp.ndarray,    # (B, nwin, Nw, 3*heads*d)
    rel: jnp.ndarray,    # (B, nwin, Nw, heads*32) — [rel_h | rel_w | 0] per head
    sel32: jnp.ndarray,  # (32, Nw): make_rel_scatter padded with zero rows
    scale: float,
    heads: int,
    d: int,
) -> jnp.ndarray:
    """Windowed rel-pos attention -> d-major (B, nwin, heads*d, Nw)."""
    B, nwin, Nw, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, d, scale)  # (B, nwin, heads, Nw, d)
    relh = jnp.moveaxis(rel.reshape(B, nwin, Nw, heads, 32), 3, 2)
    return _d_major(xla_attention_relpos(q, k, v, relh, sel32))


def qkv_packed_windows_s(
    qkv: jnp.ndarray,    # (BW, Nw, 3*heads*d) — flat windows
    rel_s: jnp.ndarray,  # (Nw, BW, heads*32) — position-major packed rel
    sel32: jnp.ndarray,  # (32, Nw)
    scale: float,
    heads: int,
    d: int,
) -> jnp.ndarray:
    """`qkv_packed_windows` with position-major rel (the layout
    `rel_smajor_windows` emits) -> d-major (BW, heads*d, Nw)."""
    BW, Nw, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, d, scale)  # (BW, heads, Nw, d)
    relh = rel_s.reshape(Nw, BW, heads, 32).transpose(1, 2, 0, 3)
    return _d_major(xla_attention_relpos(q, k, v, relh, sel32))


def qkv_packed_edge(
    qkv: jnp.ndarray,   # (B, n, R, 3*heads*d) — packed qkv, uniform edge rows
    rel: jnp.ndarray,   # (B, n, R, heads*32) — rel factors + Lpad in lane 28
    sel: jnp.ndarray,   # (n, 32, R) per-window scatter (compact_window.edge_consts)
    vb: jnp.ndarray,    # (heads, d) — v slice of the qkv bias (pad value)
    kmask: jnp.ndarray, # (n, 1, R) fp32: 0 real keys / -1e30 dummy columns
    scale: float,
    heads: int,
    d: int,
) -> jnp.ndarray:
    """Partially-padded-window attention on the compact (pad-free) layout.

    Each window has R uniform rows (real tokens + zero dummies for narrower
    windows); its pad keys are one virtual key per query whose logit rides
    rel lane LPAD_LANE and whose value is `vb` (see ops/compact_window.py).
    Output is d-major (B, n, heads*d, R)."""
    B, n, R, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, d, scale)  # (B, n, heads, R, d)
    relh = jnp.moveaxis(rel.reshape(B, n, R, heads, REL_LANES), 3, 2)
    s = jnp.einsum("bnhqc,bnhkc->bnhqk", q, k, preferred_element_type=jnp.float32)
    s = s + jnp.einsum(
        "bnhqr,nrk->bnhqk", relh, sel.astype(relh.dtype),
        preferred_element_type=jnp.float32,
    )
    s = s + kmask[None, :, None]
    lp = relh[..., LPAD_LANE].astype(jnp.float32)[..., None]  # (B, n, h, R, 1)
    m = jnp.maximum(jnp.max(s, axis=-1, keepdims=True), lp)
    p = jnp.exp(s - m)
    pp = jnp.exp(lp - m)
    l = jnp.sum(p, axis=-1, keepdims=True) + pp
    o = jnp.einsum(
        "bnhqk,bnhkc->bnhqc", (p / l).astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    )
    o = o + (pp / l) * vb.astype(jnp.float32)[None, None, :, None, :]
    return _d_major(o.astype(qkv.dtype))


def qkv_packed_plain(
    qkv: jnp.ndarray,  # (B, S, 3*heads*d)
    scale: float,
    heads: int,
    d: int,
) -> jnp.ndarray:
    """Plain softmax attention (the CLIP towers) -> d-major (B, heads*d, S)."""
    q, k, v = _split_heads(qkv, heads, d, scale)  # (B, heads, S, d)
    s = jnp.einsum("bhqc,bhkc->bhqk", q, k, preferred_element_type=jnp.float32)
    p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
    o = jnp.einsum("bhqk,bhkc->bhqc", p, v, preferred_element_type=jnp.float32)
    return _d_major(o.astype(v.dtype))


def qkv_packed_global_xla(
    qkv: jnp.ndarray,   # (B, N, 3*heads*d)
    rel: jnp.ndarray,   # (N, B, heads, H+W) — position-major [rel_h | rel_w]
    scale: float,
    heads: int,
    d: int,
    H: int,
    W: int,
) -> jnp.ndarray:
    """Global-block rel-pos attention as an XLA formulation -> rows
    (B, N, heads*d). Writes the (B, heads, N, N) float32 scores and bias."""
    B, N, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, d, scale)  # (B, heads, N, d)
    sel = make_rel_scatter(H, W, dtype=qkv.dtype)
    o = xla_attention_relpos(q, k, v, rel.transpose(1, 2, 0, 3), sel)
    return jnp.moveaxis(o, 1, 2).reshape(B, N, heads * d)


def batch_partitioned(fn):
    """`fn(qkv, rel) -> out` as one op that XLA's SPMD partitioner splits
    along the batch axis only (qkv and out axis 0, rel axis 1); every other
    axis is gathered first. A Pallas kernel is an opaque custom call, which
    the partitioner would otherwise run on fully gathered operands on every
    device. On one device `fn` is inlined."""
    f = custom_partitioning(lambda qkv, rel: fn(qkv, rel))

    def partition(mesh, arg_shapes, result_shape):
        batch = arg_shapes[0].sharding.spec[0] if arg_shapes[0].sharding.spec else None
        qkv_s = NamedSharding(mesh, P(batch, None, None))
        rel_s = NamedSharding(mesh, P(None, batch, None, None))
        return mesh, fn, qkv_s, (qkv_s, rel_s)

    f.def_partition(
        partition=partition,
        sharding_rule="b n c, n b h r -> b n e",
        need_replication_factors=("n", "c", "h", "r", "e"),
    )
    return f


def qkv_packed_global(
    qkv: jnp.ndarray,   # (B, N, 3*heads*d)
    rel: jnp.ndarray,   # (N, B, heads, H+W) — position-major [rel_h | rel_w]
    scale: float,
    heads: int,
    d: int,
    H: int,
    W: int,
) -> jnp.ndarray:
    """Global-block rel-pos attention -> rows (B, N, heads*d).

    On CUDA devices, for 16-bit inputs, the forward runs
    `global_attention_triton`, which never writes the (B, heads, N, N)
    scores or bias to device memory; otherwise `qkv_packed_global_xla`
    runs. The backward is always the XLA formulation's VJP."""
    args = (scale, heads, d, H, W)

    def xla(qkv, rel):
        return qkv_packed_global_xla(qkv, rel, *args)

    # The kernel's key tile is one grid row (W a power of two). float32
    # inputs keep the XLA formulation: measured on the card, the kernel is
    # within 4% of it at default precision, and under precision "highest"
    # (how float32 references run) its dots take ~90x longer (PERF.md).
    if W & (W - 1) or qkv.dtype.itemsize > 2:
        return xla(qkv, rel)
    kernel = batch_partitioned(
        lambda qkv, rel: global_attention_triton(qkv, rel, *args)
    )

    def fwd(qkv, rel):
        return jax.lax.platform_dependent(qkv, rel, cuda=kernel, default=xla)

    return pallas_with_xla_vjp(fwd, xla)(qkv, rel)
