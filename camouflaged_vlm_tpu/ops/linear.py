"""Fused linear layers of the ViT blocks, written as XLA formulations.

Each function is one block-level step: LN (+ pad mask) -> qkv projection,
LN -> MLP -> residual, attention output -> projection (+ residual). XLA hands
the matrix products to the GPU's GEMM libraries with bias/activation
epilogues and fuses the LN prologues into elementwise kernels. Matrix
products take the compute dtype with float32 accumulation; LN statistics
and activations are float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _apply_act(acc, activation):
    if activation == "gelu_tanh":
        return jax.nn.gelu(acc, approximate=True)
    if activation == "gelu":
        return jax.nn.gelu(acc, approximate=False)
    if activation == "quick_gelu":
        return acc * jax.nn.sigmoid(1.702 * acc)
    return acc


def _ln32(x, gamma, beta, eps):
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mu), axis=-1, keepdims=True)
    xn = (x32 - mu) * jax.lax.rsqrt(var + eps)
    return x32, xn * gamma.astype(jnp.float32) + beta.astype(jnp.float32)


def ln_linear_act_bt(
    x: jnp.ndarray,       # (B, S, K)
    gamma: jnp.ndarray,   # (1, K)
    beta: jnp.ndarray,    # (1, K)
    w: jnp.ndarray,       # (K, N)
    b: jnp.ndarray,       # (1, N)
    eps: float = 1e-5,
    activation: str | None = "quick_gelu",
) -> jnp.ndarray:
    """act(LN(x) @ w + b) in x.dtype."""
    _, xn = _ln32(x, gamma, beta, eps)
    acc = jnp.einsum(
        "bsk,kn->bsn", xn.astype(x.dtype), w, preferred_element_type=jnp.float32
    )
    return _apply_act(acc + b.astype(jnp.float32), activation).astype(x.dtype)


def ln_mask_linear_bt(
    x: jnp.ndarray,       # (B', S, K) — B' = B * nwin (window-carry layout)
    gamma: jnp.ndarray,   # (1, K)
    beta: jnp.ndarray,    # (1, K)
    mask: jnp.ndarray,    # (nwin, S, 1) row mask, indexed by B' % nwin
    w: jnp.ndarray,       # (K, N)
    b: jnp.ndarray,       # (1, N)
    eps: float = 1e-6,
) -> jnp.ndarray:
    """(LN(x) * mask) @ w + b — the ViT block's LN1 and pad-token re-zeroing
    ahead of the qkv projection. Every image shares the same per-window
    validity pattern, so row b' takes mask[b' % nwin]."""
    Bp, S, _ = x.shape
    nwin = mask.shape[0]
    _, xn = _ln32(x, gamma, beta, eps)
    m = jnp.broadcast_to(
        mask[None].astype(jnp.float32), (Bp // nwin, nwin, S, 1)
    ).reshape(Bp, S, 1)
    acc = jnp.einsum(
        "bsk,kn->bsn", (xn * m).astype(x.dtype), w,
        preferred_element_type=jnp.float32,
    )
    return (acc + b.astype(jnp.float32)).astype(x.dtype)


def ln_mlp_residual_bt(
    x: jnp.ndarray,       # (B', S, K) — also the residual
    gamma: jnp.ndarray,   # (1, K)
    beta: jnp.ndarray,    # (1, K)
    w1: jnp.ndarray,      # (K, H)
    b1: jnp.ndarray,      # (1, H)
    w2: jnp.ndarray,      # (H, K)
    b2: jnp.ndarray,      # (1, K)
    eps: float = 1e-6,
    activation: str = "gelu_tanh",
) -> jnp.ndarray:
    """x + MLP(LN(x)): the pre-norm MLP half of a ViT block."""
    x32, xn = _ln32(x, gamma, beta, eps)
    h = jnp.einsum(
        "bsk,kh->bsh", xn.astype(x.dtype), w1, preferred_element_type=jnp.float32
    )
    h = _apply_act(h + b1.astype(jnp.float32), activation)
    acc = jnp.einsum(
        "bsh,hk->bsk", h.astype(x.dtype), w2, preferred_element_type=jnp.float32
    )
    return (acc + b2.astype(jnp.float32) + x32).astype(x.dtype)


def proj_rows(
    x: jnp.ndarray,             # (B, T, K, S) — d-major attention output
    w: jnp.ndarray,             # (K, out)
    b: jnp.ndarray,             # (1, out)
    res: jnp.ndarray = None,    # (B, T, S, out) — optional residual
) -> jnp.ndarray:
    """out[b, t, s, :] = x[b, t, :, s] @ w + bias (+ res) -> (B, T, S, out)."""
    acc = jnp.einsum("btks,ko->btso", x, w, preferred_element_type=jnp.float32)
    acc = acc + b.astype(jnp.float32)
    if res is not None:
        acc = acc + res.astype(jnp.float32)
    return acc.astype(x.dtype)


def proj_from_heads(
    x: jnp.ndarray,    # (B, heads, T, S, d) — head-leading attention output
    w: jnp.ndarray,    # (heads, d, out) — reshaped (heads*d, out) projection
    b: jnp.ndarray,    # (1, out)
    res: jnp.ndarray = None,  # (B, T, S, out) — optional residual
) -> jnp.ndarray:
    """out[b, t, s, :] = sum_h x[b, h, t, s] @ w[h] + bias (+ res)."""
    acc = jnp.einsum("bhtsd,hdo->btso", x, w, preferred_element_type=jnp.float32)
    acc = acc + b.astype(jnp.float32)
    if res is not None:
        acc = acc + res.astype(jnp.float32)
    return acc.astype(x.dtype)
