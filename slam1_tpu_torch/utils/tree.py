"""Trees of tuples and NamedTuples with tensors (or numbers) as leaves:
the state containers that checkpoints save and step graphs capture."""

from __future__ import annotations


def flatten(tree) -> list:
    """The leaves of a tree of tuples, depth first."""
    if isinstance(tree, tuple):
        return [leaf for child in tree for leaf in flatten(child)]
    return [tree]


def unflatten(like, leaves):
    """`like`'s structure filled from the iterator `leaves`."""
    if isinstance(like, tuple):
        children = [unflatten(child, leaves) for child in like]
        return (type(like)(*children) if hasattr(like, "_fields")
                else tuple(children))
    return next(leaves)
