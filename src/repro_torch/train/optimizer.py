"""AdamW over nested dicts of tensors, in place, with complex support.

Port of ``repro.train.optimizer`` for one device (ZeRO-1, the moment
sharding over a data-parallel mesh, comes with the model-parallel slice).
The arithmetic is the reference's: global-norm clip scale, bias
corrections, ``mu / (sqrt(nu) + eps)``, weight decay on real leaves only;
complex leaves (the FNO's spectral weights) keep a real second moment
``nu = E[|g|^2]`` in float32.

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.common.tree import chunks, global_norm, tree_leaves, tree_map


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


def init_opt_state(params: dict) -> dict:
    """Zero moments with the params' layout; ``nu`` of a complex leaf is a
    float32 tensor (E[|g|^2] is real). ``count`` is an int32 scalar."""

    def moment(p, second):
        if p.is_complex() and second:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return torch.zeros_like(p)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {
        "mu": tree_map(lambda p: moment(p, False), params),
        "nu": tree_map(lambda p: moment(p, True), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


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
def adamw_update(grads: dict, opt_state: dict, params: dict, cfg: AdamWConfig):
    """One AdamW step on ``params`` and ``opt_state``, in place.

    ``grads`` are torch's ``.grad`` of each leaf (same tree as ``params``).
    Returns ``(params, opt_state, stats)`` with ``stats = {"grad_norm",
    "lr"}``, like the reference; the trees returned are the ones passed in.
    """
    count = int(opt_state["count"]) + 1
    lr = cfg.lr_at(count)

    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    # the bias corrections in float32, as the reference computes them
    c = torch.tensor(count, dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
    for p, g, mu, nu in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]),
    ):
        _update_leaf(p, g, mu, nu, scale=scale, lr=lr, b1=b1, b2=b2,
                     bc1=bc1, bc2=bc2, eps=cfg.eps, wd=cfg.weight_decay)
    opt_state["count"].fill_(count)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
