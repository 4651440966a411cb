"""Random-Fourier dense positional encoding for the mask decoder.

Equivalent of `PositionEmbeddingRandom`
(`/root/reference/models/sam_maskdecoder_edge.py:76-110`): a fixed Gaussian
(2, C/2) matrix maps normalised grid coords to sin/cos features. The matrix is
a *buffer* in the reference (overwritten by the checkpoint at load), so here
it is a parameter initialised with unit normals and restored from checkpoints.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def random_position_embedding(gaussian_matrix: jnp.ndarray, size: int) -> jnp.ndarray:
    """gaussian_matrix: (2, C/2). Returns (size, size, C) fp32 PE grid."""
    coords = (np.arange(size, dtype=np.float32) + 0.5) / size  # cumsum(ones)-0.5 normalised
    y = jnp.asarray(coords)[:, None]  # (H, 1)
    x = jnp.asarray(coords)[None, :]  # (1, W)
    grid = jnp.stack(
        [jnp.broadcast_to(x, (size, size)), jnp.broadcast_to(y, (size, size))],
        axis=-1,
    )  # (H, W, 2), order (x, y) as in the reference
    proj = (2.0 * grid - 1.0) @ gaussian_matrix.astype(jnp.float32)
    proj = 2.0 * jnp.pi * proj
    return jnp.concatenate([jnp.sin(proj), jnp.cos(proj)], axis=-1)


def init(num_pos_feats: int, key) -> dict:
    """(2, C/2) unit-normal Gaussian matrix (C/2 = num_pos_feats)."""
    return {
        "positional_encoding_gaussian_matrix": jax.random.normal(
            key, (2, num_pos_feats), jnp.float32
        )
    }
