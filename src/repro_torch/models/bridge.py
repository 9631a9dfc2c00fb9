"""Carry a parameter tree of numpy arrays (e.g. the reference's weights,
fetched to the host) into torch tensors with the same nesting and layout."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["keyed_leaves", "params_from_numpy", "tree_leaves", "tree_map"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts, lists, tuples and
    NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Every leaf of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def keyed_leaves(tree, prefix: str = ""):
    """(key string, leaf) pairs in ``jax.tree_util``'s order and with its
    ``keystr`` names: dict keys sorted (``['k']``), sequences by index
    (``[i]``), NamedTuple fields by name (``.field``).  Two trees of one
    structure give the same keys whatever their dicts' insertion order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keyed_leaves(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from keyed_leaves(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from keyed_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # numpy extension dtype: reinterpret
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_numpy(tree, device):
    """Dicts, lists and tuples are walked; every leaf becomes a tensor on
    ``device`` with the leaf's own dtype, so the leaves a model keeps in
    f32 whatever its dtype (rglru's ``ba``, ``bx``, ``lam``; rwkv6's
    ``w0``, ``u``) stay f32 in a bf16 tree.  No transposes: the port keeps
    the reference's layouts."""
    return tree_map(lambda a: _tensor(a, device), tree)
