"""Error-feedback gradient compression for the data-parallel group.

Port of ``repro.train.compression`` on ``torch.distributed``. Top-k
sparsification with local error feedback (Stich et al. / Deep Gradient
Compression lineage): each worker reduces only the k largest-magnitude
gradient entries (after adding its residual from previous rounds); the
rest accumulate locally. Wire cost drops from O(n) to O(k * P) per tensor
(values + indices all-gathered), which pays off on a slow data-parallel
link where all-reducing full FNO spectral gradients (GBs) dominates step
time.

Every rank of the data group calls it with its own gradients:
    new_grads, new_err = compressed_psum_mean(grads, err, group, ratio=0.01)

As in the reference, the reduction is a dense scatter of each rank's top-k
entries followed by an all-reduce SUM and a division by P (the same result
as gathering (vals, idx) from every peer and scatter-adding); the wire
bytes of the sparse form are modelled by ``wire_bytes_compressed``.
Complex leaves are ranked by magnitude (``torch.abs``, as ``jnp.abs``)
and reduced as their real view. Like the reference's trainer, the port's
does not call it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _topk_sparsify(g: torch.Tensor, k: int):
    flat = g.reshape(-1)
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx


def _mean_over(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over the group's ranks: all-reduce SUM, then / P."""
    out = t.clone()
    dist.all_reduce(torch.view_as_real(out) if out.is_complex() else out, group=group)
    return out.div_(dist.get_world_size(group))


def compress_leaf(
    g: torch.Tensor, err: torch.Tensor, group, ratio: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: returns (mean-reduced dense grad, new local error)."""
    if g.numel() < 64:  # tiny leaves: dense mean, no point compressing
        return _mean_over(g, group), torch.zeros_like(err)
    corrected = (g + err).reshape(-1)
    k = max(1, int(g.numel() * ratio))
    vals, idx = _topk_sparsify(corrected, k)
    sparse = torch.zeros_like(corrected)
    sparse[idx] = vals
    new_err = (corrected - sparse).reshape(g.shape)
    return _mean_over(sparse.reshape(g.shape), group), new_err


def compressed_psum_mean(grads, err_state, group, *, ratio: float = 0.01):
    """Nested-dict version. ``err_state`` matches ``grads``' structure
    (zeros initially); returns (reduced, new error state)."""
    if isinstance(grads, dict):
        pairs = {k: compressed_psum_mean(grads[k], err_state[k], group, ratio=ratio)
                 for k in grads}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    return compress_leaf(grads, err_state, group, ratio)


def init_error_state(grads):
    """Zeros shaped like ``grads`` (a nested dict of tensors)."""
    if isinstance(grads, dict):
        return {k: init_error_state(v) for k, v in grads.items()}
    return torch.zeros_like(grads)


def wire_bytes_dense(n_elems: int, itemsize: int, p: int) -> float:
    """Ring all-reduce bytes per device."""
    return 2.0 * n_elems * itemsize * (p - 1) / p


def wire_bytes_compressed(n_elems: int, itemsize: int, p: int, ratio: float) -> float:
    """All-gather of (vals f32 + idx i32) per peer."""
    k = max(1, int(n_elems * ratio))
    return float(k * (itemsize + 4) * (p - 1))
