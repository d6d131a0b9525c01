"""Nested-container helpers: the port's stand-in for ``jax.tree``.

A tree is a nested dict, tuple or list; anything else is a leaf.  Dict
keys go in sorted order and sequence items by index, the order
``jax.tree_util.tree_flatten_with_path`` gives the same containers, so
a path joined with "/" is the JAX package's checkpoint key for the same
leaf (``0/period/slot0/moe/wg``).
"""

from __future__ import annotations


def leaves(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """(path, leaf) of every leaf, dict keys sorted, sequence items by
    index (the path holds the int)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def map_tree(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn, tree, prefix: tuple = ()):
    """fn(path, leaf) over the leaves of ``tree``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def get(tree, path):
    """The node of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def key(path) -> str:
    """A path joined with "/", as the checkpoint names its leaf."""
    return "/".join(str(k) for k in path)
