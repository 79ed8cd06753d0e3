"""Flattening of nested state in the JAX package's leaf order.

A checkpoint stores one file per leaf, numbered in the order
``jax.tree.flatten`` gives: dict keys sorted, lists and tuples in order,
``None`` an empty subtree; anything else (a tensor, an array, a scalar) is a
leaf.  The port flattens its state the same way, so a checkpoint written by
either package restores in the other.  ``str`` of a :class:`TreeDef` is the
``PyTreeDef(...)`` text that the JAX manager writes into the manifest.
"""

from __future__ import annotations

from typing import Any


class TreeDef:
    """The structure of a flattened tree: ``("leaf",)``, ``("none",)``, or
    ``(kind, keys, children)`` for ``kind`` in dict / list / tuple."""

    def __init__(self, node: tuple):
        self.node = node

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        tree = _build(self.node, it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree holds")
        return tree

    def __str__(self) -> str:
        return f"PyTreeDef({_text(self.node)})"


_END = object()


def flatten(tree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` of ``tree`` in the JAX package's order."""
    leaves: list = []
    return leaves, TreeDef(_walk(tree, leaves))


def _walk(x, leaves: list) -> tuple:
    # a module-level function: a nested recursive closure would sit in a reference
    # cycle with ``leaves`` and keep every leaf (a whole training state) alive until
    # the garbage collector runs
    if isinstance(x, dict):
        keys = sorted(x)
        return ("dict", keys, [_walk(x[k], leaves) for k in keys])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, None, [_walk(v, leaves) for v in x])
    if x is None:
        return ("none",)
    leaves.append(x)
    return ("leaf",)


def leaves(tree) -> list:
    return flatten(tree)[0]


def _build(node: tuple, it) -> Any:
    kind = node[0]
    if kind == "leaf":
        x = next(it, _END)
        if x is _END:
            raise ValueError("fewer leaves than the tree holds")
        return x
    if kind == "none":
        return None
    _, keys, children = node
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    return built if kind == "list" else tuple(built)


def _text(node: tuple) -> str:
    kind = node[0]
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    _, keys, children = node
    parts = [_text(c) for c in children]
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {p}" for k, p in zip(keys, parts)) + "}"
    if kind == "list":
        return "[" + ", ".join(parts) + "]"
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
