"""Parameter trees: nested dicts and tuples of tensors, as in ``repro``.

Leaves are visited in JAX's order (dict keys sorted, tuples in order), so
a sum over leaves adds in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence


def leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for node in tree for x in leaves(node)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, *nodes) for nodes in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(like: Any, flat: Sequence[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves, in :func:`leaves` order,
    are ``flat``'s items."""
    it = iter(flat)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return tuple(build(x) for x in node)
        return next(it)

    return build(like)
