"""Minimal pytrees with the reference's flattening order.

``jax.tree_util`` flattens dicts in SORTED key order and the FlatBuffer's
leaf offsets follow that order; ``torch.utils._pytree`` flattens dicts in
insertion order. So the port carries its own flatten: dicts (sorted keys),
lists and tuples are nodes, everything else is a leaf, and ``()`` is an
empty node (the momentum-free SGD state).
"""
from __future__ import annotations

from typing import Any, Callable

#: path entries, as the checkpoint keys spell them: ("k", key) / ("i", index)
PathEntry = tuple


class TreeDef:
    """The structure of a pytree, without its leaves (hashable)."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: str, keys: tuple = (), children: tuple = ()):
        self.kind, self.keys, self.children = kind, keys, children

    def _id(self) -> tuple:
        return (self.kind, self.keys, tuple(c._id() for c in self.children))

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self._id() == other._id()

    def __hash__(self) -> int:
        return hash(self._id())

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "dict":
            inner = ", ".join(f"{k!r}: {c!r}" for k, c in zip(self.keys, self.children))
            return "{" + inner + "}"
        inner = ", ".join(repr(c) for c in self.children)
        return f"[{inner}]" if self.kind == "list" else f"({inner})"


LEAF = TreeDef("leaf")


def tree_flatten_with_path(tree: Any, prefix: tuple = (), is_leaf=None
                           ) -> tuple[list[tuple[tuple, Any]], TreeDef]:
    """``is_leaf(node)`` True stops the walk there, as jax's ``is_leaf``
    (a spec tree's ``sharding.P`` entries are tuples)."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)], LEAF
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        out, defs = [], []
        for k in keys:
            sub, d = tree_flatten_with_path(tree[k], prefix + (("k", k),),
                                            is_leaf)
            out += sub
            defs.append(d)
        return out, TreeDef("dict", keys, tuple(defs))
    if isinstance(tree, (list, tuple)):
        out, defs = [], []
        for i, item in enumerate(tree):
            sub, d = tree_flatten_with_path(item, prefix + (("i", i),), is_leaf)
            out += sub
            defs.append(d)
        kind = "list" if isinstance(tree, list) else "tuple"
        return out, TreeDef(kind, (), tuple(defs))
    return [(prefix, tree)], LEAF


def tree_flatten(tree: Any, is_leaf=None) -> tuple[list, TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree: Any, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)
    tree = _build(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError(f"too many leaves for {treedef}")
    return tree


_END = object()


def _build(treedef: TreeDef, it) -> Any:
    if treedef.kind == "leaf":
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("too few leaves for the tree structure")
        return leaf
    children = [_build(c, it) for c in treedef.children]
    if treedef.kind == "dict":
        return dict(zip(treedef.keys, children))
    return children if treedef.kind == "list" else tuple(children)


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf=None) -> Any:
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r, is_leaf)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {r_def}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def path_str(path: tuple) -> str:
    """A flatten path as the npz checkpoint key: ``k:layers/k:attn/k:wq``."""
    return "/".join(f"{kind}:{key}" for kind, key in path)
