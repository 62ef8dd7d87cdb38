"""Nested parameter and state trees of tensors: leaves in the reference's order.

A tree is a dict, list, tuple or NamedTuple of trees, a tensor (or array)
leaf, or None (no leaves).  Leaves come in the order `jax.tree_util`
flattens the same structure (dict keys sorted, sequences and NamedTuple
fields in order), and each leaf's path is named as `jax.tree_util.keystr`
names it (`.params['stages'][0]['mamba_0']['mamba']['in_proj']`), so that
a checkpoint written by either package names its leaves alike.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in the reference's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], f"{prefix}[{key!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from leaves_with_path(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_path(sub, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_structure(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leaf by leaf over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_structure(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_structure(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_structure(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree of `like`'s structure holding `new_leaves` (in `leaves` order)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
