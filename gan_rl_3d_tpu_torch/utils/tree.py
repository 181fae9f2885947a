"""Nested dict/list trees of tensors, the port's stand-in for JAX pytrees.
Tuples and named tuples (optax states) are nodes too.

Dict keys are visited in sorted order, as ``jax.tree`` flattens them.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf; dicts, lists and tuples keep their
    structure and None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v) for v in tree])
    if tree is None:
        return None
    return fn(tree)


def _rebuild(seq, items: list):
    """A list, tuple or named tuple of ``seq``'s type holding ``items``."""
    if hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in tree_leaves
    order."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            built = {k: build(tree[k]) for k in sorted(tree)}
            return {k: built[k] for k in tree}
        if isinstance(tree, (list, tuple)):
            return _rebuild(tree, [build(v) for v in tree])
        if tree is None:
            return None
        return next(it)

    return build(like)
