"""Nested dicts, tuples and lists of tensors: the port's counterpart of the
reference's pytrees (parameters, optimizer state, model carries).

Leaves are visited in the order ``jax.tree`` visits them (dict keys
sorted), so the port's leaves line up with the reference's in tests."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of every
    tree in ``rest`` (same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """A tree shaped like ``like`` holding ``leaves`` (in `tree_leaves`
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def tree_index(tree, idx):
    """Every leaf indexed by ``idx`` (views, no copies)."""
    return tree_map(lambda x: x[idx], tree)
