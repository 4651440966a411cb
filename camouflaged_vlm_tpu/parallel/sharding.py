"""Parameter partition rules (tensor parallelism).

Megatron-style sharding expressed as path->PartitionSpec rules; XLA's GSPMD
propagation inserts the collectives. Column-parallel layers (qkv / MLP up
projections) shard their output features; row-parallel layers (attention
output / MLP down projections) shard their input features, producing one
all-reduce per block.

Dense kernels are (in_features, out_features).
"""

from __future__ import annotations

import re
from typing import Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# (regex over 'a/b/c' param path, spec) — first match wins.
_RULES: Tuple[Tuple[str, P], ...] = (
    # column-parallel: shard output features
    (r"(qkv|in_proj|lin1|c_fc|q_proj|k_proj|v_proj)/kernel$", P(None, "model")),
    (r"(qkv|in_proj|lin1|c_fc|q_proj|k_proj|v_proj)/bias$", P("model")),
    # row-parallel: shard input features
    (r"(attn/proj|out_proj|lin2|c_proj)/kernel$", P("model", None)),
    # rel-pos tables index by head_dim (last axis) — replicate
    # conv kernels, norms, embeddings, biases of row-parallel layers: replicate
)


def param_partition_spec(path: str, ndim: int) -> P:
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            if len([a for a in spec if a is not None]) <= ndim:
                return spec
    return P()


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def make_param_shardings(mesh: Mesh, params):
    """Pytree of NamedShardings matching `params`."""

    def to_sharding(path, leaf):
        spec = param_partition_spec(_path_str(path), leaf.ndim)
        return NamedSharding(mesh, spec)

    return jax.tree_util.tree_map_with_path(to_sharding, params)


def _put(leaf, sharding: NamedSharding):
    """device_put that also works when `sharding` spans other processes'
    devices (multi-host): every process holds the full host-side value and
    contributes its addressable shards."""
    if jax.process_count() == 1:
        return jax.device_put(leaf, sharding)
    import numpy as np

    host = np.asarray(leaf)
    return jax.make_array_from_callback(host.shape, sharding, lambda idx: host[idx])


def shard_params(mesh: Mesh, params):
    """Device-put params according to the partition rules."""
    shardings = make_param_shardings(mesh, params)
    return jax.tree.map(_put, params, shardings)


def make_replicated_array(mesh: Mesh, x):
    """Fully-replicated global array from identical host data on each process."""
    return _put(x, NamedSharding(mesh, P()))


def make_global_batch_array(sharding: NamedSharding, global_arr, batch_axis=0):
    """Assemble a batch-axis-sharded global jax.Array from host data.

    Single-process: a plain device_put. Multi-process (after
    `jax.distributed.initialize`): every process holds the SAME global batch
    (the data stream is seed-deterministic, so ranks agree without any
    exchange — the multi-host replacement for the reference's per-rank
    DistributedSampler, `train_ovcos_maskdecoder_edge.py:287-293`) and
    contributes only the contiguous row slice its addressable devices own.
    Requires the batch axis to divide evenly across processes.
    `batch_axis=1` for gradient-accumulation tensors ((A, B/A, ...) — the
    leading microbatch axis is unsharded)."""
    if jax.process_count() == 1:
        return jax.device_put(global_arr, sharding)
    import numpy as np

    n, p = jax.process_count(), jax.process_index()
    B = global_arr.shape[batch_axis]
    assert B % n == 0, (B, n)
    # The contiguous-rows-per-process assumption only holds for meshes built
    # from the default process-ordered device list with the model axis
    # inside a host — verify it against the sharding's actual index map
    # rather than silently feeding permuted per-device batches.
    idx_map = sharding.devices_indices_map(tuple(global_arr.shape))
    mine = [
        ix[batch_axis] for d, ix in idx_map.items() if d.process_index == p
    ]
    lo = min(s.start or 0 for s in mine)
    hi = max(B if s.stop is None else s.stop for s in mine)
    assert (lo, hi) == (p * (B // n), (p + 1) * (B // n)), (
        f"process {p}'s devices own batch rows [{lo}, {hi}) but "
        f"make_global_batch_array assumes [{p * (B // n)}, "
        f"{(p + 1) * (B // n)}) — rebuild the mesh from the default "
        f"process-ordered device list (parallel.make_mesh())"
    )
    idx = [slice(None)] * global_arr.ndim
    idx[batch_axis] = slice(p * (B // n), (p + 1) * (B // n))
    local = np.asarray(global_arr[tuple(idx)])
    return jax.make_array_from_process_local_data(sharding, local)
