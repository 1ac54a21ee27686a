"""Nested-dict (pytree) helpers shared by the trainer and the optimizer.

Port of what the trainer needs from ``repro.common.tree``. A tree is a
nested dict whose leaves are tensors; leaves are visited in sorted key
order, as ``jax.tree.leaves`` visits a dict, so sums over leaves add in the
reference's order.
"""
from __future__ import annotations

from typing import Optional

import torch

# Elements per slice when a reduction or an elementwise update walks one
# large leaf: the FNO's stacked spectral weight is 12.6 GB at the paper's
# width, so a whole-leaf temporary would cost that much again.
CHUNK = 1 << 24


def tree_leaves(tree) -> list:
    """The leaves of a nested dict (lists count as nodes), sorted by key."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the matching leaves of trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


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
