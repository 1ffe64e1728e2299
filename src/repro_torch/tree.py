"""The port's parameter trees: nested dicts and lists of tensors, in the
JAX package's pytree layout.  Leaves come in ``jax.tree.leaves``' order,
so that a port tree and a JAX tree can be walked side by side."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree: Any) -> List[Any]:
    """The leaves in a fixed order: dict keys sorted, as ``jax.tree.leaves``
    orders a dict's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """``like``'s structure with the leaves of ``flat``, in :func:`leaves`'
    order."""
    return _build(like, iter(flat))


def _build(t: Any, it: Iterator[Any]) -> Any:
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle that holds ``flat`` (a gradient tree,
    # say) until the cyclic collector runs
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same structure with ``fn`` applied to each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
