"""Trees of tensors: nested dicts, lists and tuples, as JAX's pytrees of them.

Leaves are visited in the order the containers hold them (a dict by its keys'
insertion order).  Every rank of a collective walks the same tree the same
way, which is all the order has to give.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of ``tree``, with the leaves at the same place in ``rest``."""
    if isinstance(tree, dict):
        if any(not isinstance(o, dict) or set(o) != set(tree) for o in rest):
            raise ValueError(f"trees differ: keys {sorted(tree)}")
        return {k: tree_map(fn, v, *(o[k] for o in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(not isinstance(o, (list, tuple)) or len(o) != len(tree) for o in rest):
            raise ValueError(f"trees differ: a sequence of {len(tree)}")
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten_like(tree, flat: List[Any]):
    """``tree``'s structure with the leaves of ``flat``, in ``leaves`` order."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out
