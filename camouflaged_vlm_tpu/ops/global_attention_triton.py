"""Global-block attention with the decomposed rel-pos bias, as a Pallas
kernel for the Triton route (NVIDIA GPUs).

The SAM encoder's global blocks attend over the whole H x W token grid
(ViT-H: 64 x 64 = 4096 tokens, 16 heads of d = 80). The XLA formulation
(`ops.attention.xla_attention_relpos`) writes the (B, heads, N, N) scores
and the (B, heads, N, N) `rel @ sel` bias to device memory in float32. This
kernel never forms either: it walks the keys in tiles of one grid row
(block_k == W), so a key tile has one `kh` and `kw = 0..W-1`, and its bias
tile is `rel_h[:, kh]` broadcast over the columns plus the query tile's
`rel_w` slab, which is loaded once. The softmax is online, in float32
(FlashAttention-2), in base 2 as in the Pallas GPU attention example that
ships with JAX (`jax/experimental/pallas/ops/gpu/attention.py`, whose
forward loop this kernel follows).

q, k and v are read straight from the packed qkv projection, viewed as
(B, N, 3 * heads, d): each head slice is one masked load of a power-of-two
width (d = 80 -> 128 lanes, 48 masked). The output is written the same way
into (B, N, heads, d). The backward pass is the XLA formulation's VJP
(`ops.vjp.pallas_with_xla_vjp`), applied by the caller.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _kernel(q_ref, k_ref, v_ref, rel_ref, o_ref, *, scale, d, H, W):
    block_q = q_ref.shape[0]
    d_pad = q_ref.shape[-1]
    head_mask = (jnp.arange(d_pad) < d)[None, :]
    log2e = math.log2(math.e)

    q = plgpu.load(q_ref, mask=head_mask, other=0.0)
    q = q * jnp.asarray(scale, q.dtype)
    # rel_w of this query tile: one (block_q, W) slab for every key tile
    rel_w = rel_ref[:, H : H + W].astype(jnp.float32) * log2e

    def body(kh, carry):
        o, m, l = carry
        rows = pl.ds(kh * W, W)
        k = plgpu.load(k_ref.at[rows, :], mask=head_mask, other=0.0)
        s = pl.dot(q, k.T).astype(jnp.float32) * log2e  # (block_q, W)
        rel_h = rel_ref[:, pl.ds(kh, 1)].astype(jnp.float32) * log2e
        s = s + rel_h + rel_w
        m_new = jnp.maximum(m, jnp.max(s, axis=-1))
        corr = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = corr * l + jnp.sum(p, axis=-1)
        v = plgpu.load(v_ref.at[rows, :], mask=head_mask, other=0.0)
        o = corr[:, None] * o + pl.dot(p.astype(v.dtype), v).astype(jnp.float32)
        return o, m_new, l

    init = (
        jnp.zeros((block_q, d_pad), jnp.float32),
        jnp.full((block_q,), -jnp.inf, jnp.float32),
        jnp.zeros((block_q,), jnp.float32),
    )
    o, _, l = jax.lax.fori_loop(0, H, body, init)
    o = o / l[:, None]
    plgpu.store(o_ref, o.astype(o_ref.dtype), mask=head_mask)


def global_attention_triton(
    qkv: jnp.ndarray,   # (B, N, 3*heads*d) — packed qkv projection
    rel: jnp.ndarray,   # (N, B, heads, H+W) — position-major [rel_h | rel_w]
    scale: float,
    heads: int,
    d: int,
    H: int,
    W: int,
    block_q: int = 64,
    num_warps: int = 4,
    num_stages: int = 3,
    interpret: bool = False,
) -> jnp.ndarray:
    """softmax(scale * q k^T + bias) v per head -> (B, N, heads * d).

    Needs N == H * W with W a power of two: the key tile is one grid row."""
    B, N, _ = qkv.shape
    hw = rel.shape[-1]
    assert N == H * W and hw == H + W, (N, H, W, hw)
    assert W & (W - 1) == 0, W
    block_q = min(block_q, N)
    assert N % block_q == 0, (N, block_q)
    d_pad = pl.next_power_of_2(d)
    hw_pad = pl.next_power_of_2(hw)  # lanes past H + W are never read
    qkv4 = qkv.reshape(B, N, 3 * heads, d)
    kernel = functools.partial(_kernel, scale=scale, d=d, H=H, W=W)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, N, heads, d), qkv.dtype),
        grid=(N // block_q, B, heads),
        in_specs=[
            pl.BlockSpec((None, block_q, None, d_pad),
                         lambda i, b, h: (b, i, h, 0)),
            pl.BlockSpec((None, N, None, d_pad),
                         lambda i, b, h: (b, 0, heads + h, 0)),
            pl.BlockSpec((None, N, None, d_pad),
                         lambda i, b, h: (b, 0, 2 * heads + h, 0)),
            pl.BlockSpec((block_q, None, None, hw_pad),
                         lambda i, b, h: (i, b, h, 0)),
        ],
        out_specs=pl.BlockSpec((None, block_q, None, d_pad),
                               lambda i, b, h: (b, i, h, 0)),
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="sam_global_attention",
    )(qkv4, qkv4, qkv4, rel)
    return out.reshape(B, N, heads * d)
