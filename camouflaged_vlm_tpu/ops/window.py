"""Window partition / unpartition for windowed ViT attention.

Behavioural equivalent of the reference's
`/root/reference/models/mmseg/models/sam/image_encoder.py:507-553`, expressed
as static reshapes+transposes so XLA fuses them into the surrounding matmuls.
Shapes are fully static (SAM ViT-H: 64x64 tokens, window 14 -> pad to 70x70,
25 windows of 14x14 per image).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def window_partition(x: jnp.ndarray, window: int) -> Tuple[jnp.ndarray, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWin, window, window, C), plus padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    if pad_h or pad_w:
        x = jnp.pad(x, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C)
    return x, (Hp, Wp)


def window_unpartition(
    windows: jnp.ndarray, window: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> jnp.ndarray:
    """Inverse of :func:`window_partition`; crops padding back to (H, W)."""
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // ((Hp // window) * (Wp // window))
    x = windows.reshape(B, Hp // window, Wp // window, window, window, C)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :]
    return x


def window_partition_seq(x: jnp.ndarray, window: int) -> Tuple[jnp.ndarray, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWin, window*window, C) window-major SEQUENCE
    layout, plus padded (Hp, Wp).

    Used by the encoder's window-carry mode: x stays in this layout across
    consecutive windowed blocks (one partition per windowed run instead of a
    partition + unpartition pair per block)."""
    xw, pad_hw = window_partition(x, window)
    return xw.reshape(xw.shape[0], window * window, x.shape[-1]), pad_hw


def window_unpartition_seq(
    xw: jnp.ndarray, window: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> jnp.ndarray:
    """Inverse of :func:`window_partition_seq` (crops back to hw)."""
    return window_unpartition(
        xw.reshape(xw.shape[0], window, window, xw.shape[-1]), window, pad_hw, hw
    )


def window_valid_mask(H: int, W: int, window: int) -> jnp.ndarray:
    """(nWin, window*window, 1) 0/1 mask of tokens inside the unpadded (H, W).

    In carry mode, padded positions accumulate garbage between blocks (the
    reference re-pads fresh zeros after every LN1); multiplying LN1's output
    by this mask restores the reference's invariant that padded tokens enter
    attention as exact zeros (their k/v then equal the qkv bias, which IS the
    reference semantics — it zero-pads activations, not logits)."""
    import numpy as np

    Hp = -(-H // window) * window
    Wp = -(-W // window) * window
    hh = np.arange(Hp)[:, None] < H
    ww = np.arange(Wp)[None, :] < W
    m = (hh & ww).astype(np.float32)  # (Hp, Wp)
    m = m.reshape(Hp // window, window, Wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window, 1)
    return jnp.asarray(m)
