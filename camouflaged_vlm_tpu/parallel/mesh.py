"""Device mesh construction.

Replaces the reference's NCCL DDP machinery
(`/root/reference/train_ovcos_maskdecoder_edge.py:25-29,287-293`) with a
`jax.sharding.Mesh`: the device list reshaped to (data, model). Every card
of an NVLink host reaches every other at the same rate, so the mesh follows
the algorithm alone. Axes:

  * `data`  — batch sharding (data parallelism). Gradient psum is inserted
    by XLA from the sharding annotations — note this *fixes* the reference's
    broken DDP (it unwraps `.module` before training, so its ranks never
    synchronised gradients; see SURVEY.md §5.8). We keep the correct
    semantics and document the deviation.
  * `model` — tensor parallelism over attention heads / MLP hidden dims
    (Megatron-style). Not needed for capacity (the 1B-param cascade fits one
    card) but free to enable for latency scaling.

Multi-host runs: call `jax.distributed.initialize()` before `make_mesh`
(all jax processes then see the global device set).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    assert n_data * n_model == len(devices), (
        f"mesh {n_data}x{n_model} != {len(devices)} devices"
    )
    arr = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))


def batch_spec(ndim: int) -> P:
    """Shard the leading (batch) axis over `data`; replicate the rest."""
    return P("data", *([None] * (ndim - 1)))


def replicated_spec() -> P:
    return P()
