"""Leaf order of the reference's trees: ``jax.tree.leaves`` visits dict
keys sorted, NamedTuple and tuple fields in order.  The optimizers sum
the gradient norm in this order, as the reference does."""

from __future__ import annotations


def sorted_paths(tree, path=()):
    """(path, leaf) pairs in the reference's order; a path is a tuple of
    dict keys and field positions.  ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_paths(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from sorted_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def sorted_leaves(tree):
    return [leaf for _, leaf in sorted_paths(tree)]
