"""Train-step factory: gradients + AdamW + optional gradient accumulation,
on one device or across ranks.

Port of ``repro.train.train_loop.make_train_step``, and of what
``shard_train_step``'s shardings make of it across ranks. PyTorch runs
eagerly, so there is nothing to jit: the step differentiates ``loss_fn``
with autograd, sums the micro-batches' gradients in preallocated buffers,
divides by ``grad_accum`` and updates params and optimizer state in place.
Across ranks (a ``StateLayout``) each rank differentiates the loss of its
own shard of the batch; the gradients are then reduced as the reference's
partitioner reduces them (``reduce_grads``) before the AdamW step.

The gradient buffers are the one subtle part. The FNO stacks its blocks'
weights in one leaf (``blocks.w_spec`` is 12.6 GB at the paper's width),
an LM its layers' (gemma-7b's ``layers.mlp.w_gate`` is 1.2 GB at 4
layers), and indexing a leaf per block makes autograd's select-backward
form a zero-filled gradient of the whole leaf for every block. So the step
hands ``loss_fn`` a params tree of fresh leaf views instead: each leaf
under ``blocks``, ``layers`` or ``superblocks`` becomes a list of per-block
views, every view's ``.grad`` is bound to the matching slice of one
preallocated buffer, and autograd accumulates into those slices in place.
LM trees also hold lists (a hybrid's ``tail``) and None (``layer0`` of a
model whose first layer is not dense), which every walk here keeps.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.common.tree import STACKED_KEYS, chunks, tree_leaves, tree_leaves_like, tree_map
from repro_torch.core.collectives import counted
from repro_torch.train.optimizer import AdamWConfig, StateLayout, adamw_update


def zeros_like_tree(params: dict) -> dict:
    return tree_map(torch.zeros_like, params)


def _grad_views(params: dict, grads: dict) -> dict:
    """A params tree of leaves that share the params' memory, require grad
    and accumulate their gradients into ``grads`` (same tree, same shapes).
    Leaves under one of ``STACKED_KEYS`` (the FNO's blocks, an LM's layers
    and superblocks) are split into per-block views along dim 0, which a
    model indexes as it indexes the stacked tensor."""

    def leaf(p, g):
        v = p.detach().requires_grad_()
        v.grad = g
        return v

    def per_block(p, g):
        return [leaf(p[i], g[i]) for i in range(p.shape[0])]

    def walk(p, g, stacked):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k], stacked or k in STACKED_KEYS) for k in p}
        if isinstance(p, list):
            return [walk(a, b, stacked) for a, b in zip(p, g)]
        if p is None:
            return None
        return per_block(p, g) if stacked else leaf(p, g)

    return walk(params, grads, False)


def accumulate_grads(loss_fn: Callable, params: dict, batch, grads: dict):
    """Add d loss / d params (torch's ``.grad`` convention) into ``grads``;
    returns ``(loss, metrics)`` detached."""
    loss, metrics = loss_fn(_grad_views(params, grads), batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def _all_reduce(t: torch.Tensor, group) -> None:
    """Sum ``t`` over ``group`` in place, in ``CHUNK``-sized pieces (a
    block of the spectral weights' gradient is several GB); complex
    tensors travel as their real view."""
    if group is not None and dist.get_world_size(group) == 1:
        return
    for c in chunks(torch.view_as_real(t) if t.is_complex() else t):
        with counted("all-reduce", c, group):
            dist.all_reduce(c, group=group)


@torch.no_grad()
def reduce_grads(grads: dict, layout: StateLayout) -> None:
    """The global gradient from every rank's gradient of its local mean
    loss, in place. Two rules, by what a rank's gradient holds.

    The FNO's: each rank backpropagates the mean over its own points (its
    rows, its part of the domain), so the global mean's gradient is the
    mean of the local means' (equal shards). A replicated leaf is summed
    over every rank (world); a sharded leaf (``w_spec``) over the data
    group only, since the all-to-alls' backward has already brought its
    model group's cotangents to the rank that owns the shard. Then all
    divide by the world size D*P.

    The LM's over (data x model), ``layout.grads_complete``: every rank of
    a model group holds the same loss, that of its data rank's rows, and
    each rank's gradient of a leaf is the whole of it for that loss. A
    leaf split over the model group is complete on its rank: the column-
    and row-parallel products, the all-to-alls and the all-gathers of
    weights bring every cotangent to the rank that owns the shard. A
    whole (replicated) leaf is a copy on every rank of the group; where a
    rank uses it on its part only (the norms on its slice of the sequence
    under ``seq_shard``, the router on its tokens, q/k-norm on its heads),
    the layer's ``copy_to`` sums the group's parts in the backward. So
    every leaf is averaged over the data group alone: summed there and
    divided by D.
    """
    if layout.grads_complete:
        data = layout.groups["data"]
        for g in tree_leaves(grads):
            _all_reduce(g, data)
            g.div_(dist.get_world_size(data))
        return
    world = dist.get_world_size()
    for g, part in zip(tree_leaves(grads), tree_leaves_like(layout.params, grads)):
        _all_reduce(g, layout.groups["data"] if part is not None else None)
        g.div_(world)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, *, grad_accum: int = 1,
                    layout: Optional[StateLayout] = None,
                    mark: Optional[Callable[[str], None]] = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``loss_fn(params, batch) -> (loss, metrics)``.

    With ``grad_accum > 1`` the batch's leading dim is split into that many
    micro-batches, run one after the other; their gradients are summed and
    divided by ``grad_accum``, and the loss and metrics averaged, as in the
    reference. Params and optimizer state are updated in place and
    returned.

    With a ``layout`` every rank calls the step on its local params, its
    local batch and its optimizer state (``init_opt_state(params,
    layout)``); ``loss_fn`` returns the mean over the rank's own points.
    The gradients are reduced (``reduce_grads``), the step is the sharded
    AdamW of ``adamw_update``, and the loss and metrics reported are the
    global means, the same on every rank. Every rank runs the same
    collectives in the same order.

    ``mark(name)``, if given, is called where the step's parts meet:
    "backward" once the gradients are summed, "reduced" after
    ``reduce_grads`` (with a ``layout`` only) and "updated" after the
    AdamW update; it adds no synchronisation (a caller records CUDA events
    there to time the parts).
    """
    buffers = {}
    mark = mark or (lambda name: None)

    def train_step(params, opt_state, batch):
        grads = buffers.get("grads")
        if grads is None:
            grads = buffers["grads"] = zeros_like_tree(params)
        else:
            tree_map(torch.Tensor.zero_, grads)
        if grad_accum == 1:
            loss, metrics = accumulate_grads(loss_fn, params, batch, grads)
        else:
            micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
            if any(len(v) != grad_accum or v[0].shape[0] * grad_accum != batch[k].shape[0]
                   for k, v in micro.items()):
                raise ValueError(
                    f"batch of {next(iter(batch.values())).shape[0]} does not "
                    f"split into grad_accum={grad_accum} equal micro-batches"
                )
            losses, per_micro = [], []
            for i in range(grad_accum):
                loss, metrics = accumulate_grads(
                    loss_fn, params, {k: v[i] for k, v in micro.items()}, grads
                )
                losses.append(loss)
                per_micro.append(metrics)
            with torch.no_grad():
                tree_map(lambda g: g.div_(grad_accum), grads)
            loss = torch.stack(losses).sum() / grad_accum
            metrics = {
                k: torch.stack([m[k] for m in per_micro]).mean(0) for k in per_micro[0]
            }
        mark("backward")
        if layout is not None:
            reduce_grads(grads, layout)
            mark("reduced")
            metrics = dict(metrics, loss=loss)
            for k, v in metrics.items():
                v = v.clone()
                dist.all_reduce(v)
                metrics[k] = v / dist.get_world_size()
            loss = metrics.pop("loss")
        params, opt_state, stats = adamw_update(grads, opt_state, params, opt_cfg, layout)
        mark("updated")
        return params, opt_state, dict(metrics, loss=loss, **stats)

    return train_step
