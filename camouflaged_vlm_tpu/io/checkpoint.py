"""Native checkpointing (orbax): params + optimizer state + step.

Fixes the reference's broken resume (its `resume` key only restores the
epoch counter, never weights or optimizer —
`/root/reference/train_ovcos_maskdecoder_edge.py:167-172`): here the full
TrainState round-trips.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax


def save_checkpoint(path: str, state: Any, force: bool = True) -> None:
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, state, force=force)
    ckptr.wait_until_finished()


def restore_checkpoint_host(path: str) -> Any:
    """Restore a checkpoint as host numpy arrays, regardless of the device
    topology it was saved under (a multi-host-written checkpoint embeds the
    saving mesh's device ids, which a target-less restore would try — and
    fail — to reconstruct)."""
    import jax.tree_util as jtu
    import numpy as np
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path).item_metadata
    tree = meta.tree if hasattr(meta, "tree") else meta
    leaves, treedef = jtu.tree_flatten(tree)
    restore_args = jtu.tree_unflatten(
        treedef, [ocp.RestoreArgs(restore_type=np.ndarray)] * len(leaves)
    )
    return ckptr.restore(path, restore_args=restore_args)


def restore_train_params_host(path: str) -> Any:
    """Restore a `cli/train.py` checkpoint as a host-numpy params tree.

    The saved TrainState keeps `trainable`/`frozen` as FLAT dicts whose tuple
    keys orbax stringifies on save; this helper owns that format (the repr
    round-trip + unflatten) so its consumers cannot drift. A bare params tree (or a
    `{'params': ...}` variables dict) passes through unchanged."""
    import ast

    from ..utils.tree import unflatten_dict

    tree = restore_checkpoint_host(path)
    if isinstance(tree, dict) and "trainable" in tree and "frozen" in tree:
        flat = {}
        for part in ("trainable", "frozen"):
            for k, v in tree[part].items():
                key = ast.literal_eval(k) if isinstance(k, str) else k
                flat[key if isinstance(key, tuple) else (key,)] = v
        return unflatten_dict(flat)
    return tree


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    if target is not None:
        abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, target)
        return ckptr.restore(path, abstract)
    return ckptr.restore(path)
