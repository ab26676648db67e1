"""Nested-dict trees (the port's pytrees): leaves in sorted-key order,
which is the reference's pytree order, and rebuilding from them."""

from __future__ import annotations


def leaves(tree, prefix=()) -> list:
    """(path, leaf) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def from_leaves(pairs) -> dict:
    """The nested dict of (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and same-structure ``rest``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
