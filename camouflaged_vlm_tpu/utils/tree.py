"""Nested-dict <-> flat tuple-keyed dict conversion for parameter trees."""

from __future__ import annotations

from typing import Any, Dict, Tuple


def flatten_dict(tree: Dict, prefix: Tuple = ()) -> Dict[Tuple, Any]:
    """{'a': {'b': x}} -> {('a', 'b'): x}. Non-dict values are leaves."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            flat.update(flatten_dict(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def unflatten_dict(flat: Dict[Tuple, Any]) -> Dict:
    """Inverse of `flatten_dict`."""
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree
