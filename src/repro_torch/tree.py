"""Nested containers of tensors ("trees"), walked as ``jax.tree_util`` walks
them: dicts in sorted key order, lists and tuples by index, NamedTuples by
field. The optimizers sum over leaves in that order (the gradient norm) and
the checkpoints name each leaf by its path in that order, so both agree
with the JAX package's."""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_map", "tree_leaves", "leaves_with_path", "map_with_path", "path_key", "unflatten_like"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on every leaf of ``tree`` (and the same leaf of each of
    ``rest``, which have ``tree``'s structure); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves_with_path(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` in JAX's leaf order; a path entry is a dict key, a
    list index, or ``.field`` for a NamedTuple field (JAX's ``GetAttrKey``
    as ``str`` gives)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, path + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    """The leaves in JAX's order (``jax.tree.leaves``)."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path: tuple) -> str:
    """A leaf's flat name, its path joined by ``/`` (the JAX package's
    checkpoint keys)."""
    return "/".join(path)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: tuple = ()) -> Any:
    """``fn(path_key(path), leaf)`` on every leaf; the structure is kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, path + ("." + n,)) for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path_key(path), tree)


def unflatten_like(tree: Any, leaves: list) -> Any:
    """``tree``'s structure holding ``leaves``, given in JAX's leaf order
    (``jax.tree.unflatten``)."""
    by_key = {path_key(p): leaf for (p, _), leaf in zip(leaves_with_path(tree), leaves, strict=True)}
    return map_with_path(lambda key, _: by_key[key], tree)
