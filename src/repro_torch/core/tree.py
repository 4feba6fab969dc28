"""Trees of tensors as nested dicts: the few ``jax.tree_util`` pieces the
port uses (map, leaves in order, rebuild from leaves, leaves by path)."""

from __future__ import annotations

from typing import Dict

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "tree_paths"]


def tree_map(fn, *trees):
    """``fn`` over the leaves of ``trees`` (the structure of the first)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in the tree's order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_paths(tree, sep: str = ".", prefix: str = "") -> Dict[str, object]:
    """``{sep-joined path: leaf}`` in the tree's order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_paths(v, sep, f"{prefix}{sep}{k}" if prefix
                                  else str(k)))
        return out
    return {prefix: tree}
