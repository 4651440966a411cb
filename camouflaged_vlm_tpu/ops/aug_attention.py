"""Decomposed rel-pos attention via feature augmentation.

The ViTDet bias is rank-structured: ``bias[q,k] = rel_h[q, kh(k)] +
rel_w[q, kw(k)]`` with ``rel_h = einsum(q, Rh)``. That outer structure is an
inner product:

    bias[q,k] = < [rel_h[q,:], rel_w[q,:]] , [onehot(kh(k)), onehot(kw(k))] >

so attention-with-bias becomes STANDARD attention over augmented features:

    q' = [q * scale, rel_h[q], rel_w[q]]      (d + H + W)
    k' = [k,          onehot_kh, onehot_kw]
    softmax(q' @ k'^T) @ v

This removes the (seq x seq) bias materialisation and lets a standard
attention kernel run unchanged. For SAM ViT-H:

  * windowed blocks: d' = 80 + 14 + 14 = 108 -> padded 128;
  * global blocks: d' = 80 + 64 + 64 = 208 -> padded 256.

Numerics: the augmented features are cast to the compute dtype; logits
accumulate in fp32 via preferred_element_type.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .rel_pos import get_rel_pos_table


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def augment_qk(
    q: jnp.ndarray,
    k: jnp.ndarray,
    rel_pos_h: Optional[jnp.ndarray],
    rel_pos_w: Optional[jnp.ndarray],
    hw: Tuple[int, int],
    scale: float,
    pad_to: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """q, k: (..., H*W, d) -> (q', k'): (..., H*W, d_aug) with d_aug padded.

    q is pre-scaled so the downstream kernel runs with sm_scale == 1.
    """
    H, W = hw
    d = q.shape[-1]
    qs = q * jnp.asarray(scale, q.dtype)

    if rel_pos_h is None:
        d_aug = _round_up(d, pad_to)
        pad = [(0, 0)] * (q.ndim - 1) + [(0, d_aug - d)]
        return jnp.pad(qs, pad), jnp.pad(k, pad)

    Rh = get_rel_pos_table(H, H, rel_pos_h)  # (H, H, d)
    Rw = get_rel_pos_table(W, W, rel_pos_w)  # (W, W, d)
    rq = q.reshape(q.shape[:-2] + (H, W, d))
    # NOTE: bias uses the UNSCALED q (reference semantics).
    rel_h = jnp.einsum("...hwc,hkc->...hwk", rq, Rh.astype(q.dtype))
    rel_w = jnp.einsum("...hwc,wkc->...hwk", rq, Rw.astype(q.dtype))
    rel_h = rel_h.reshape(q.shape[:-1] + (H,))
    rel_w = rel_w.reshape(q.shape[:-1] + (W,))

    eye_h = jnp.eye(H, dtype=k.dtype)  # onehot(kh)
    eye_w = jnp.eye(W, dtype=k.dtype)
    n = H * W
    onehot_h = jnp.repeat(eye_h, W, axis=0)  # (H*W, H): row k -> onehot(k // W)
    onehot_w = jnp.tile(eye_w, (H, 1))       # (H*W, W): row k -> onehot(k % W)
    bshape = k.shape[:-2] + (n,)
    k_aug = jnp.concatenate(
        [
            k,
            jnp.broadcast_to(onehot_h, bshape + (H,)),
            jnp.broadcast_to(onehot_w, bshape + (W,)),
        ],
        axis=-1,
    )
    q_aug = jnp.concatenate([qs, rel_h.astype(q.dtype), rel_w.astype(q.dtype)], axis=-1)

    d_aug = _round_up(d + H + W, pad_to)
    pad = [(0, 0)] * (q.ndim - 1) + [(0, d_aug - (d + H + W))]
    return jnp.pad(q_aug, pad), jnp.pad(k_aug, pad)


def attention_xla(q_aug: jnp.ndarray, k_aug: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Plain attention on augmented features (fp32 softmax)."""
    logits = jnp.einsum(
        "...qc,...kc->...qk", q_aug, k_aug, preferred_element_type=jnp.float32
    )
    probs = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum(
        "...qk,...kc->...qc", probs.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    ).astype(v.dtype)
