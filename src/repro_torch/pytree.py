"""Nested dicts of leaves in the reference's order.

The port keeps parameters, optimizer state and checkpoints as nested
dicts with the JAX package's keys. JAX flattens a dict in sorted key
order (``jax.tree.leaves``), not in insertion order, and names a leaf by
its keys joined with ``/`` (``jax.tree_util.tree_flatten_with_path``, as
``src/repro/checkpoint/manager.py`` writes them). Where the order shows
in a result (the sum of ``optim.adamw.global_norm``, and so the clip
scale) or in a file (a checkpoint's keys), the port walks its dicts
here. Everything that is not a dict is a leaf. Host code: no torch.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def items(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of ``tree``, keys sorted at every
    level, paths ``"a/b/c"`` as the reference's checkpoints key them."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from items(tree[k], f"{prefix}/{k}" if prefix else str(k))


def leaves(tree) -> list:
    """Every leaf of ``tree`` in ``jax.tree.leaves``' order."""
    return [leaf for _, leaf in items(tree)]


def map_leaves(fn: Callable, tree, *rest):
    """A tree of ``tree``'s structure holding ``fn(leaf, *other_leaves)``,
    the other trees' leaves taken at the same keys."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: map_leaves(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}
