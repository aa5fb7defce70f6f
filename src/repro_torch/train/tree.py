"""Nested dicts of tensors, the port's counterpart of the reference's
pytrees (parameters, optimizer state, checkpoints): leaves walked in
sorted-key order, the order ``jax.tree_util`` flattens a dict in."""

from __future__ import annotations

__all__ = ["items", "map_tree", "get_path", "unflatten"]


def items(tree, prefix: tuple = ()):
    """(path, leaf) of every leaf, the path a tuple of keys, keys sorted."""
    for key in sorted(tree):
        val = tree[key]
        path = prefix + (key,)
        if isinstance(val, dict):
            yield from items(val, path)
        else:
            yield path, val


def map_tree(fn, tree, *rest):
    """``fn(leaf, *leaves of rest at the same path)`` over ``tree``, as a
    new nested dict (leaves may be None)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def get_path(tree, path: tuple):
    """The leaf of ``tree`` at ``path``, or None where there is none."""
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def unflatten(paths, leaves) -> dict:
    """The nested dict with ``leaves`` at ``paths`` (``items``' inverse)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out
