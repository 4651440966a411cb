"""Layers as plain functions over nested parameter dicts.

Every model module in this package is a pair: an `init_*` function that
builds its parameter dict from a PRNG key, and an apply function that takes
that dict first. Parameter names and shapes follow the Flax Linen layout the
checkpoint converters (`io/convert.py`) and saved checkpoints use:
dense kernels are (in, out), conv kernels (kh, kw, in, out), and
transposed-conv kernels (kh, kw, out, in).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.norms import layer_norm

_lecun_normal = jax.nn.initializers.lecun_normal()


class Keys:
    """A stream of fresh PRNG keys drawn from one root key."""

    def __init__(self, key):
        self._key = key

    def __call__(self):
        self._key, sub = jax.random.split(self._key)
        return sub


def normal(key, shape, stddev: float) -> jnp.ndarray:
    return stddev * jax.random.normal(key, shape, jnp.float32)


def dense_init(key, din: int, dout: int) -> dict:
    return {
        "kernel": _lecun_normal(key, (din, dout), jnp.float32),
        "bias": jnp.zeros((dout,), jnp.float32),
    }


def dense(p: dict, x: jnp.ndarray, dtype) -> jnp.ndarray:
    """x @ kernel + bias with inputs and params cast to `dtype`."""
    x = x.astype(dtype)
    y = jax.lax.dot_general(
        x, p["kernel"].astype(dtype), (((x.ndim - 1,), (0,)), ((), ()))
    )
    return y + p["bias"].astype(dtype)


def ln_init(dim: int) -> dict:
    return {
        "scale": jnp.ones((dim,), jnp.float32),
        "bias": jnp.zeros((dim,), jnp.float32),
    }


def ln(p: dict, x: jnp.ndarray, eps: float) -> jnp.ndarray:
    """LayerNorm over the last axis with float32 statistics."""
    return layer_norm(x, p["scale"], p["bias"], eps)


def conv_init(key, kh: int, kw: int, cin: int, cout: int, bias: bool) -> dict:
    p = {"kernel": _lecun_normal(key, (kh, kw, cin, cout), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((cout,), jnp.float32)
    return p


def conv(p: dict, x: jnp.ndarray, stride: int, padding: str, dtype) -> jnp.ndarray:
    """NHWC convolution, kernel (kh, kw, in, out)."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def conv_transpose_init(key, kh: int, kw: int, cin: int, cout: int) -> dict:
    return {
        "kernel": _lecun_normal(key, (kh, kw, cout, cin), jnp.float32),
        "bias": jnp.zeros((cout,), jnp.float32),
    }


def conv_transpose(
    p: dict, x: jnp.ndarray, stride: int, padding: str, dtype
) -> jnp.ndarray:
    """NHWC transposed convolution with the kernel stored as the forward
    convolution's (kh, kw, out, in) — torch ConvTranspose2d semantics."""
    y = jax.lax.conv_transpose(
        x.astype(dtype), p["kernel"].astype(dtype), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), transpose_kernel=True,
    )
    return y + p["bias"].astype(dtype)
