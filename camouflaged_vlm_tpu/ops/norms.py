"""Layer normalisation with fp32 statistics.

bf16 matmuls feed the tensor cores, but norm statistics must be fp32 for
numerical parity with the reference (which runs LayerNorm in fp32 even
under fp16 — `/root/reference/alpha_clip_rw/model.py:162-168`). The SAM tower
uses eps=1e-6 (`/root/reference/models/sam_maskdecoder_edge.py:129`), the
decoder/CLIP towers use eps=1e-5 (torch default).

With NHWC layouts, the reference's `LayerNorm2d` (channel-only normalisation
of an NCHW tensor, `/root/reference/models/mmseg/models/sam/common.py`) is the
same op as a last-axis `layer_norm` — no transpose needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """Normalise the last axis in fp32; return in x.dtype."""
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    y = y * scale.astype(jnp.float32) + bias.astype(jnp.float32)
    return y.astype(orig_dtype)
