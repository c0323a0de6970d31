"""Nested containers of tensors — the port's parameter, gradient and
optimizer-state trees — walked in the order of JAX's pytrees: dict keys
sorted, lists and tuples in order, None an empty subtree (it holds no
leaf). Any other object is a leaf. The checkpoint format and the
optimizer's leaf order follow from this order, so a checkpoint either
package writes restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def _is_node(node) -> bool:
    return node is None or isinstance(node, (dict, list, tuple))


def _walk(tree) -> Iterator[Any]:
    if tree is None:
        return
    if _is_node(tree):
        for child in _children(tree):
            yield from _walk(child)
    else:
        yield tree


def leaves(tree) -> List[Any]:
    """The leaves in JAX's order (``jax.tree_util.tree_leaves``)."""
    return list(_walk(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s leaves, called
    in JAX's leaf order, in ``tree``'s structure (``jax.tree.map``; dicts
    come back with their keys sorted, as JAX's do); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (``jax.tree_util.tree_unflatten``)."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints
    it: ``PyTreeDef({'a': *, 'b': [*, None]})``."""
    def fmt(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"
