"""Nested containers of tensors ("trees"): the parameter tree (dicts and
tuples), :class:`~repro_torch.optim.adamw.OptState` (a NamedTuple) and
checkpoint state.  Paths name leaves as the reference's
``jax.tree_util`` paths do -- dict keys in sorted order, tuple indices,
NamedTuple field names -- so a leaf id such as ``params.periods.0.attn.wq``
or ``opt.count`` is the same in both packages."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["leaves", "leaves_with_path", "tree_map", "tree_map_with_path",
           "leaf_id"]


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves_with_path(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from leaves_with_path(getattr(tree, k), path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def leaf_id(path: Tuple) -> str:
    """Dotted id of a leaf path (``"root"`` for a bare leaf)."""
    return ".".join(str(k) for k in path) or "root"


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilding ``tree``'s containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, rebuilding its
    containers."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, k),
                                               path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
