"""Nested-dict (pytree) helpers shared by the trainer and the optimizer.

Port of what the trainer needs from ``repro.common.tree``. A tree is a
nested dict (or list) whose leaves are tensors; None is an empty subtree,
as in JAX (an LM's ``layer0`` when its first layer is not dense). Leaves
are visited in sorted key order, as ``jax.tree.leaves`` visits a dict, so
sums over leaves add in the reference's order.
"""
from __future__ import annotations

from typing import Optional

import torch

# Elements per slice when a reduction or an elementwise update walks one
# large leaf: the FNO's stacked spectral weight is 12.6 GB at the paper's
# width, so a whole-leaf temporary would cost that much again.
CHUNK = 1 << 24


# the keys whose leaves stack one entry per block or layer on dim 0: the
# FNO's blocks, an LM's (or whisper's encoder's and decoder's) layers, the
# hybrid family's superblocks
STACKED_KEYS = ("blocks", "layers", "superblocks")


def tree_leaves(tree) -> list:
    """The leaves of a nested dict (lists count as nodes, None as an empty
    one), sorted by key."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_leaves_like(tree, like) -> list:
    """The nodes of ``tree`` at the places of ``like``'s leaves, in
    ``tree_leaves(like)``'s order: a partition tree's entries (None for a
    replicated leaf) beside the leaves of the params or gradients they lay
    out."""
    if isinstance(like, dict):
        return [n for k in sorted(like) for n in tree_leaves_like(tree[k], like[k])]
    if isinstance(like, list):
        return [n for t, v in zip(tree, like) for n in tree_leaves_like(t, v)]
    return [] if like is None else [tree]


def stacked_leaves(tree, stacked: bool = False) -> list:
    """For each of ``tree_leaves(tree)``, whether it lies under one of
    ``STACKED_KEYS``."""
    if isinstance(tree, dict):
        return [f for k in sorted(tree)
                for f in stacked_leaves(tree[k], stacked or k in STACKED_KEYS)]
    if isinstance(tree, list):
        return [f for v in tree for f in stacked_leaves(v, stacked)]
    return [] if tree is None else [stacked]


def tree_map(fn, *trees):
    """``fn`` over the matching leaves of trees of the same structure as
    the first (dicts and lists are nodes; where the first is None, so is
    the result)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return None if first is None else fn(*trees)


def chunks(t: torch.Tensor):
    """A contiguous tensor as flat views of at most ``CHUNK`` elements."""
    return t.view(-1).split(CHUNK)


def sum_sq_real(leaf: torch.Tensor) -> Optional[torch.Tensor]:
    """Sum of squares of a leaf's real part as a float32 scalar (None for an
    empty leaf), in ``CHUNK``-sized slices."""
    sq = None
    for c in chunks(leaf.detach()):
        part = torch.sum(torch.square(c.real.to(torch.float32)))
        sq = part if sq is None else sq + part
    return sq


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, as a float32 scalar.

    A complex leaf counts with its real part only. That reproduces the
    reference: ``repro.common.tree.global_norm`` casts every leaf with
    ``.astype(float32)``, which keeps the real part of a complex one, so
    its gradient clipping sees only Re(d w_spec). Real and imaginary parts
    of JAX's gradient and torch's ``.grad`` differ only in the sign of the
    imaginary part, so the real part is the same on both sides.
    """
    return norm_of(sum_sq_real(leaf) for leaf in tree_leaves(tree))


def norm_of(sum_squares) -> torch.Tensor:
    """sqrt of the sum of per-leaf sums of squares, added in the order
    given (None entries skipped), as a float32 scalar."""
    total = None
    for sq in sum_squares:
        if sq is not None:
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)
