"""The port's trees: a leaf, or a dict, list, tuple or NamedTuple of trees
(parameters, Adam moments, a ``TrainState``).  Every walk over them goes
through this module, so the optimizer, the compute cast and the
checkpoint keys see the same leaves in the same order.

A path names each step down to a leaf as ``"k:<dict key>"``, ``"i:<list
or tuple index>"`` or ``"n:<NamedTuple field>"``, the entries of the JAX
package's checkpoint keys.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def walk(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[tuple, Any]]:
    """``(path, leaf)`` pairs, dicts in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (f"k:{k}",))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from walk(getattr(tree, name), path + (f"n:{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (f"i:{i}",))
    else:
        yield path, tree


def map_with_path(fn: Callable, like, path: Tuple[str, ...] = ()):
    """A tree shaped like ``like`` (each container of its own type) whose
    leaves are ``fn(path, leaf)``."""
    if isinstance(like, dict):
        return {k: map_with_path(fn, v, path + (f"k:{k}",))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*[map_with_path(fn, getattr(like, n),
                                          path + (f"n:{n}",))
                            for n in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(map_with_path(fn, v, path + (f"i:{i}",))
                          for i, v in enumerate(like))
    return fn(path, like)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in walk(tree)]


def tree_map(fn: Callable, tree):
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def unflatten(like, flat: Iterable):
    """A tree shaped like ``like`` whose leaves come from ``flat`` in
    :func:`leaves` order."""
    it = iter(flat)
    return map_with_path(lambda _, leaf: next(it), like)


def leaf_name(path) -> str:
    """The last dict key on a path (list indices skipped), as the JAX
    package's ``repro.dist.params._leaf_name``."""
    for entry in reversed(path):
        if entry.startswith("k:"):
            return entry[2:]
    return ""
