"""custom_vjp glue: kernel forward, XLA-formulation backward.

Pallas kernels have no autodiff rule, but the training path differentiates
through every encoder block (the EVP prompt generator is trainable and sits
upstream, `/root/reference/train_ovcos_maskdecoder_edge.py:301-303`). Rather
than hand-writing backward kernels, a kernel pairs with its mathematically
identical XLA formulation: the forward runs the kernel, the backward
re-linearises the XLA version (one extra XLA forward inside the backward
pass).
"""

from __future__ import annotations

from typing import Callable

import jax


def pallas_with_xla_vjp(
    pallas_impl: Callable, xla_impl: Callable
) -> Callable:
    """Wrap `pallas_impl(*tensors)` so its VJP is that of `xla_impl`.

    Both callables must take the same tensor-only positional arguments and
    produce identical outputs (shape, dtype, semantics); static configuration
    must already be closed over.
    """

    @jax.custom_vjp
    def f(*tensors):
        return pallas_impl(*tensors)

    def f_fwd(*tensors):
        return pallas_impl(*tensors), tensors

    def f_bwd(tensors, g):
        _, vjp = jax.vjp(xla_impl, *tensors)
        return vjp(g)

    f.defvjp(f_fwd, f_bwd)
    return f
