"""Bilinear resize matching torch `F.interpolate(..., align_corners=False)`.

`jax.image.resize` antialiases when downsampling (a triangle kernel wider
than 2 taps), which torch's bilinear does NOT — and the stage-2 alpha handoff
downsamples the 1024px mask to 336px in-graph
(`/root/reference/test_ovcos_maskdecoder_edge.py:111`). For exact semantics we
build the two separable interpolation matrices (2 taps per output pixel,
half-pixel centres, edge clamped) at trace time and apply them as dense
matmuls (two matrix products instead of gathers).

Used for: decoder output upsample 256->1024
(`/root/reference/models/sam_maskdecoder_edge.py:380-388`), alpha handoff
1024->336, EVP laplacian variants, and anywhere the reference calls
F.interpolate(bilinear, align_corners=False).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp


@lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix M with M @ x = bilinear resample of x."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        src_clamped = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src_clamped))
        hi = min(lo + 1, in_size - 1)
        frac = src_clamped - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


def resize_bilinear(x: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Resize (B, H, W, C) spatially; computed in fp32, returned in x.dtype."""
    _, H, W, C = x.shape
    mh = jnp.asarray(_interp_matrix(H, out_h))
    mw = jnp.asarray(_interp_matrix(W, out_w))
    if C == 1:
        # Mask/alpha maps: keep W on the lane dim. With the channel axis
        # last, a 1-wide lane dim pads to 128 physically — the 1024^2 mask
        # upsample materialised a ~1 GB intermediate at batch 8.
        y = x[..., 0].astype(jnp.float32)  # (B, H, W)
        y = jnp.einsum("oh,bhw->bow", mh, y, preferred_element_type=jnp.float32)
        y = jnp.einsum("ow,bhw->bho", mw, y, preferred_element_type=jnp.float32)
        return y[..., None].astype(x.dtype)
    y = x.astype(jnp.float32)
    y = jnp.einsum("oh,bhwc->bowc", mh, y, preferred_element_type=jnp.float32)
    y = jnp.einsum("ow,bhwc->bhoc", mw, y, preferred_element_type=jnp.float32)
    return y.astype(x.dtype)
