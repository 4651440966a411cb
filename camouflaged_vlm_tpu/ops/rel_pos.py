"""Decomposed relative-position attention (ViTDet/MViTv2 style).

The reference adds a rank-structured bias to the attention logits:
``attn[b, q, k] += rel_h[b, qh, qw, kh] + rel_w[b, qh, qw, kw]`` where
``rel_h = einsum('bhwc,hkc->bhwk', q, Rh)`` — see
`/root/reference/models/mmseg/models/sam/image_encoder.py:589-625`.

Design notes:
  * ``rel_h``/``rel_w`` are tiny (seq x side) compared to the full logits
    (seq x seq); they are computed as standalone einsums, then either the
    bias is materialised (the XLA formulations, ops/attention.py) or it is
    rebuilt tile by tile inside the global-attention kernel
    (ops/global_attention_triton.py).
  * softmax runs in fp32 regardless of the matmul dtype.
  * This module is the dense float32 reference the other paths are tested
    against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def get_rel_pos_table(q_size: int, k_size: int, rel_pos: jnp.ndarray) -> jnp.ndarray:
    """Select the (q_size, k_size, head_dim) slice of relative embeddings.

    Equivalent of `get_rel_pos` (`image_encoder.py:556-586`). All model
    configurations in this framework ship tables at exactly
    ``2*max(q,k)-1`` entries, so no resampling branch is required; we assert
    instead of silently interpolating.
    """
    max_rel_dist = 2 * max(q_size, k_size) - 1
    assert rel_pos.shape[0] == max_rel_dist, (
        f"rel_pos table has {rel_pos.shape[0]} entries, expected {max_rel_dist}"
    )
    q_coords = jnp.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = jnp.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.astype(jnp.int32)]


def rel_pos_contributions(
    q: jnp.ndarray,
    rel_pos_h: jnp.ndarray,
    rel_pos_w: jnp.ndarray,
    hw: Tuple[int, int],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compute (rel_h, rel_w) given q of shape (..., H*W, head_dim).

    Returns rel_h: (..., H, W, H) and rel_w: (..., H, W, W). NOTE: q here is
    the *unscaled* query, matching the reference which adds the bias computed
    from unscaled q to logits computed from scaled q.
    """
    H, W = hw
    Rh = get_rel_pos_table(H, H, rel_pos_h)  # (H, H, d)
    Rw = get_rel_pos_table(W, W, rel_pos_w)  # (W, W, d)
    rq = q.reshape(q.shape[:-2] + (H, W, q.shape[-1]))
    rel_h = jnp.einsum("...hwc,hkc->...hwk", rq, Rh)
    rel_w = jnp.einsum("...hwc,wkc->...hwk", rq, Rw)
    return rel_h, rel_w


def attention_with_decomposed_rel_pos(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    rel_pos_h: Optional[jnp.ndarray],
    rel_pos_w: Optional[jnp.ndarray],
    hw: Tuple[int, int],
    scale: float,
) -> jnp.ndarray:
    """Dense attention with the decomposed rel-pos bias (XLA path).

    q, k, v: (..., H*W, head_dim). Returns (..., H*W, head_dim) in q.dtype.
    Used for the 14x14 windowed blocks (196-token windows, logits are small)
    and as the reference implementation for the Pallas kernel.
    """
    H, W = hw
    logits = jnp.einsum(
        "...qc,...kc->...qk", q * scale, k, preferred_element_type=jnp.float32
    )
    if rel_pos_h is not None:
        rel_h, rel_w = rel_pos_contributions(q, rel_pos_h, rel_pos_w, hw)
        bias = rel_h[..., :, :, :, None] + rel_w[..., :, :, None, :]
        logits = logits + bias.reshape(bias.shape[:-4] + (H * W, H * W)).astype(
            jnp.float32
        )
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum(
        "...qk,...kc->...qc", probs.astype(v.dtype), v, preferred_element_type=jnp.float32
    )
    return out.astype(q.dtype)
