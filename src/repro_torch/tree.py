"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

Parameter, optimizer and batch trees are plain dicts (and, once split per
layer by :func:`repro_torch.train.state.split_layers`, lists) of tensors.
Leaves are visited in container order: dict insertion order, then list
order; :func:`sorted_leaves` visits them in ``jax.tree.leaves``' order
(dict keys sorted), for what must not depend on how a dict was built.
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["leaves", "sorted_leaves", "map_tree", "index_tree"]


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, in container order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def sorted_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` with dict keys sorted, then list order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def index_tree(tree: Any, i: int) -> Any:
    """Entry ``i`` of the leading axis of every leaf (a view, not a copy)."""
    return map_tree(lambda x: x[i], tree)
