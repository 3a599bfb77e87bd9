"""Trees of tensors in ``jax.tree``'s leaf order, for the optimizer and
checkpoints: a dict's values by sorted key, a list's or tuple's and a
NamedTuple's in order, None holding no leaf. The port's parameters are
dicts and lists of per-block dicts, its optimizer state a NamedTuple, so
a checkpoint's ``leaf_<i>`` is the same leaf in both packages wherever the
trees have the same structure."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

class _Leaf:
    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _flatten(t, out: List[Any]):
    if t is None:
        return None
    if isinstance(t, dict):
        done = {k: _flatten(t[k], out) for k in sorted(t)}
        return {k: done[k] for k in t}
    if _is_namedtuple(t):
        return type(t)(*(_flatten(v, out) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_flatten(v, out) for v in t)
    out.append(t)
    return _LEAF


def _unflatten(t, it):
    if t is None:
        return None
    if t is _LEAF:
        return next(it)
    if isinstance(t, dict):
        done = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: done[k] for k in t}
    if _is_namedtuple(t):
        return type(t)(*(_unflatten(v, it) for v in t))
    return type(t)(_unflatten(v, it) for v in t)


# (Module-level walkers: a nested recursive closure would hold its own cell
# and with it every leaf it saw until the garbage collector ran.)
def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef): the leaves in ``jax.tree.flatten``'s order, and
    the tree with each leaf replaced by a marker (dicts keep their key
    order; only the leaves' order follows the sorted keys)."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def unflatten(treedef, leaves) -> Any:
    """The inverse of :func:`flatten`."""
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), in one tree of ``tree``'s structure."""
    flat, treedef = flatten(tree)
    others = [leaves(r) for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
