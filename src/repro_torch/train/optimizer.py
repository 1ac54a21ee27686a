"""AdamW over nested dicts of tensors, in place, with complex support and
ZeRO-1.

Port of ``repro.train.optimizer``. The arithmetic is the reference's:
global-norm clip scale, bias corrections, ``mu / (sqrt(nu) + eps)``,
weight decay on real leaves only; complex leaves (the FNO's spectral
weights) keep a real second moment ``nu = E[|g|^2]`` in float32.

Two differences of form, none of result:

* Updates run in place, leaf by leaf and in slices of ``CHUNK`` elements:
  at the paper's width the spectral weight is one 12.6 GB leaf, and an
  out-of-place update would hold several temporaries of that size.
* The gradients are torch's ``.grad``. For a complex leaf that is the
  conjugate of JAX's gradient, so the update uses ``conj(grad)`` — the
  reference then subtracts JAX's gradient unconjugated, which steps
  Im(w_spec) uphill; the port reproduces that step, since parity with the
  reference is the gate. ``torch.optim.AdamW`` is no substitute: it keeps
  a second moment per real component and uses torch's sign convention.

Across ranks (a ``StateLayout``) the update sees what the reference's
SPMD partitioner makes of it: the global norm adds each sharded leaf's
shares over its model group(s), and with ZeRO-1 each data rank keeps
``mu``/``nu`` for its slice of every leaf (``zero1_partitions``, the
reference's ``zero1_specs``), updates that slice of the params and
all-gathers the slices over the data group. The numbers are those of the
unsharded update.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.common.tree import (
    chunks, global_norm, norm_of, stacked_leaves, sum_sq_real, tree_leaves, tree_leaves_like,
    tree_map,
)
from repro_torch.core.partition import CartPartition, gather_dim, local_slice


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable[[int], float]] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor`` at ``total``, in float32 as the reference computes it."""

    def sched(step):
        f32 = torch.float32
        step = torch.as_tensor(step, dtype=f32)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(torch.pi * prog))
        return float(torch.where(step < warmup, warm, cos))

    return sched


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """How a training state lies over process groups.

    ``groups`` maps the names the partitions use ("data", and "model" or
    "mx"/"my") to groups; ``params`` and ``moments`` are trees of
    ``CartPartition`` (None: replicated) over the params and over AdamW's
    ``mu``/``nu``. ``grads_complete``: each rank's gradient of each leaf
    is already the whole of it for its data rank's loss (the LM's
    tensor-parallel layers); else the FNO's, where a replicated leaf's is
    a part (``train_loop.reduce_grads``).
    """

    groups: Mapping[str, object]
    params: dict
    moments: dict
    grads_complete: bool = False

    def state(self) -> dict:
        """The partitions of a whole training state ``{"params", "opt"}``."""
        return {"params": self.params,
                "opt": {"mu": self.moments, "nu": self.moments, "count": None}}

    def zero_dim(self, p_part, m_part) -> Optional[int]:
        """The dim ZeRO-1 splits a leaf's moments along, over the data
        group, or None (moments laid out as the param, or one data rank)."""
        if m_part is None or dist.get_world_size(self.groups["data"]) == 1:
            return None
        for i, name in enumerate(m_part.dims):
            if name == "data" and (p_part is None or p_part.dims[i] != "data"):
                return i
        return None


def zero1_partitions(param_parts: dict, shapes: dict, dp_size: int, dp_axis: str = "data") -> dict:
    """Moment partitions for ZeRO-1: each param's partition plus the data
    group on the largest still-replicated dim of its global shape that
    ``dp_size`` divides (the first, on a tie), as the reference's
    ``zero1_specs``. A leaf with no such dim keeps its param partition."""

    def one(part, shape):
        dims = list(part.dims) if part is not None else [None] * len(shape)
        best, best_size = None, 0
        for i, (name, n) in enumerate(zip(dims, shape)):
            if name is None and n % dp_size == 0 and n > best_size:
                best, best_size = i, n
        if best is None:
            return part
        dims[best] = dp_axis
        return CartPartition(tuple(dims))

    return tree_map(lambda shape, part: one(part, shape), shapes, param_parts)


def state_layout(groups: Mapping[str, object], param_parts: dict, shapes: dict, *,
                 zero1: bool = True, grads_complete: bool = False) -> StateLayout:
    """The ``StateLayout`` of params partitioned by ``param_parts`` (global
    leaf shapes ``shapes``), with ZeRO-1 moments unless ``zero1=False``."""
    dp = dist.get_world_size(groups["data"])
    moments = zero1_partitions(param_parts, shapes, dp) if zero1 else param_parts
    return StateLayout(dict(groups), param_parts, moments, grads_complete)


def init_opt_state(params: dict, layout: Optional[StateLayout] = None) -> dict:
    """Zero moments with the params' layout; ``nu`` of a complex leaf is a
    float32 tensor (E[|g|^2] is real). ``count`` is an int32 scalar. With
    a ``layout`` whose moments ZeRO-1 splits, each moment holds this data
    rank's slice of its (local) param."""

    def moment(p, second, p_part=None, m_part=None):
        shape = list(p.shape)
        dim = layout.zero_dim(p_part, m_part) if layout is not None else None
        if dim is not None:
            shape[dim] //= dist.get_world_size(layout.groups["data"])
        dtype = torch.float32 if p.is_complex() and second else p.dtype
        return torch.zeros(shape, dtype=dtype, device=p.device)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    if layout is None:
        mu = tree_map(lambda p: moment(p, False), params)
        nu = tree_map(lambda p: moment(p, True), params)
    else:
        mu = tree_map(lambda p, a, b: moment(p, False, a, b), params, layout.params, layout.moments)
        nu = tree_map(lambda p, a, b: moment(p, True, a, b), params, layout.params, layout.moments)
    return {"mu": mu, "nu": nu, "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def _update_leaf(p, g, mu, nu, *, scale, lr, b1, b2, bc1, bc2, eps, wd):
    complex_leaf = p.is_complex()
    for pc, gc, mc, nc in zip(chunks(p), chunks(g), chunks(mu), chunks(nu)):
        g32 = gc.conj() if complex_leaf else gc
        if scale is not None:
            g32 = g32 * scale
        mc.mul_(b1).add_(g32, alpha=1 - b1)
        if complex_leaf:
            g2 = torch.view_as_real(g32.resolve_conj()).square().sum(-1)
        else:
            g2 = g32.square()
        nc.mul_(b2).add_(g2, alpha=1 - b2)
        delta = (mc / bc1) / (torch.sqrt(nc / bc2) + eps)
        upd = lr * delta
        if wd and not complex_leaf:
            upd += lr * wd * pc
        pc.sub_(upd)


@torch.no_grad()
def _update_zero1(p, g, mu, nu, dim: int, group, stacked: bool, **kw):
    """ZeRO-1 update of one leaf: this data rank updates its slice of ``p``
    along ``dim`` (``mu``/``nu`` are that slice) and the slices are
    all-gathered over ``group`` back into ``p``. A leaf ``stacked`` per
    block (under one of ``STACKED_KEYS``) split along a later dim goes block by
    block, so the temporaries stay a block's size; any other leaf goes in
    one slice and one all-gather."""
    blocks = [(p, g, mu, nu, dim)] if dim == 0 or not stacked else [
        (p[i], g[i], mu[i], nu[i], dim - 1) for i in range(p.shape[0])]
    for p_b, g_b, mu_b, nu_b, d in blocks:
        mine = local_slice(p_b, d, group).contiguous()
        _update_leaf(mine, local_slice(g_b, d, group).contiguous(), mu_b, nu_b, **kw)
        p_b.copy_(gather_dim(mine, d, group))


def _global_norm(grads: dict, layout: Optional[StateLayout]) -> torch.Tensor:
    """The global norm of gradients laid out by ``layout``: replicated
    leaves count once; a sharded leaf's sum of squares adds the shares of
    every rank of its model group(s)."""
    if layout is None:
        return global_norm(grads)

    def share(g, part):
        sq = sum_sq_real(g)
        if part is not None and sq is not None:
            for axes in part.dims:
                for name in (axes,) if isinstance(axes, str) else axes or ():
                    if name != "data":
                        dist.all_reduce(sq, group=layout.groups[name])
        return sq

    return norm_of(share(g, part) for g, part in zip(tree_leaves(grads),
                                                       tree_leaves_like(layout.params, grads)))


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict, cfg: AdamWConfig,
                 layout: Optional[StateLayout] = None):
    """One AdamW step on ``params`` and ``opt_state``, in place.

    ``grads`` are torch's ``.grad`` of each leaf (same tree as ``params``).
    Returns ``(params, opt_state, stats)`` with ``stats = {"grad_norm",
    "lr"}``, like the reference; the trees returned are the ones passed in.
    Across ranks, ``grads`` are the rank's reduced gradients (every rank of
    a data group holds the same) laid out as ``layout.params``, and
    ``opt_state`` is laid out by ``init_opt_state(params, layout)``.
    """
    count = int(opt_state["count"]) + 1
    lr = cfg.lr_at(count)

    gnorm = _global_norm(grads, layout)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    # the bias corrections in float32, as the reference computes them
    c = torch.tensor(count, dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
    kw = dict(scale=scale, lr=lr, b1=b1, b2=b2, bc1=bc1, bc2=bc2, eps=cfg.eps,
              wd=cfg.weight_decay)
    leaves = tree_leaves(params)
    dims = ([None] * len(leaves) if layout is None else
            [layout.zero_dim(a, b) for a, b in zip(tree_leaves_like(layout.params, params),
                                                    tree_leaves_like(layout.moments, params))])
    stacked = stacked_leaves(params)
    for p, g, mu, nu, dim, per_block in zip(
        leaves, tree_leaves(grads),
        tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]), dims, stacked,
    ):
        if dim is None:
            _update_leaf(p, g, mu, nu, **kw)
        else:
            _update_zero1(p, g, mu, nu, dim, layout.groups["data"], per_block, **kw)
    opt_state["count"].fill_(count)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
