"""FFT high-pass filter for the EVP handcrafted prompt stream.

Behavioural equivalent of `PromptGenerator.fft`
(`/root/reference/models/mmseg/models/sam/image_encoder.py:332-353`):
zero out a centred square of the shifted spectrum whose area is
``rate`` of the image (side = 2 * int(sqrt(H*W*rate)/2)), inverse-transform,
and take |real part|.

Formulation: the mask is a separable outer product ``m_h(u) * m_w(v)``, so
``ifft2(mask * fft2(x))`` collapses to two circulant matmuls
``A @ X @ B^T`` with ``A = ifft∘diag(m_h)∘fft`` — dense matrix products in
place of a generic FFT (which of the two is faster on the GPU is not
measured yet). The real part of the complex product is
``Ar X Br^T - Ai X Bi^T`` (X is real). `fft_highpass_fft` keeps the direct
jnp.fft path as the parity oracle.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp


def _line(H: int, W: int, rate: float) -> int:
    return int((H * W * rate) ** 0.5 // 2)


@lru_cache(maxsize=8)
def _lowpass_circulant(N: int, line: int):
    """Circulant matrix of ifft(diag(m)·fft(·)) along one axis, as
    (real, imag) fp32 numpy arrays. m keeps the `line` lowest positive and
    negative frequencies (the centred square in fftshift coordinates:
    unshifted k < line or k >= N - line)."""
    m = np.zeros(N)
    m[:line] = 1.0
    if line > 0:
        m[N - line :] = 1.0
    c = np.fft.ifft(m)  # first column generator: A[j, l] = c[(j - l) % N]
    idx = (np.arange(N)[:, None] - np.arange(N)[None, :]) % N
    A = c[idx]
    return A.real.astype(np.float32), A.imag.astype(np.float32)


def fft_highpass(x: jnp.ndarray, rate: float) -> jnp.ndarray:
    """x: (B, H, W, C) -> same shape, |real(ifft(highpass(fft(x))))|."""
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    H, W = x.shape[1], x.shape[2]
    line = _line(H, W, rate)
    Ar, Ai = map(jnp.asarray, _lowpass_circulant(H, line))
    Br, Bi = map(jnp.asarray, _lowpass_circulant(W, line))

    # low = real(A @ X @ B^T) = Ar X Br^T - Ai X Bi^T  (X real)
    t_r = jnp.einsum("hk,bkwc->bhwc", Ar, x32)
    t_i = jnp.einsum("hk,bkwc->bhwc", Ai, x32)
    low = jnp.einsum("bhwc,lw->bhlc", t_r, Br) - jnp.einsum(
        "bhwc,lw->bhlc", t_i, Bi
    )
    return jnp.abs(x32 - low).astype(orig_dtype)


def fft_highpass_fft(x: jnp.ndarray, rate: float) -> jnp.ndarray:
    """Direct jnp.fft formulation (parity oracle for fft_highpass)."""
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    H, W = x.shape[1], x.shape[2]
    line = _line(H, W, rate)

    mask = jnp.zeros((H, W), dtype=jnp.float32)
    mask = mask.at[H // 2 - line : H // 2 + line, W // 2 - line : W // 2 + line].set(1.0)

    f = jnp.fft.fft2(x32, axes=(1, 2), norm="forward")
    f = jnp.fft.fftshift(f, axes=(1, 2))
    f = f * (1.0 - mask)[None, :, :, None]
    f = jnp.fft.ifftshift(f, axes=(1, 2))
    inv = jnp.fft.ifft2(f, axes=(1, 2), norm="forward").real
    return jnp.abs(inv).astype(orig_dtype)
