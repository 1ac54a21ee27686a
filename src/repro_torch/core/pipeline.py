"""GPipe-style pipeline-parallel FNO — the paper's comparison baseline.

Port of ``repro.core.pipeline`` on ``torch.distributed``. The paper (Fig.
6/7) shows pipeline parallelism reaches <=50% parallel efficiency on the
FNO (no concurrency at batch size 1, bubble-bound at small microbatch
counts) while domain decomposition exceeds 90%. The schedule:

  * the n_blocks FNO blocks are the pipeline stages, one per rank of the
    stage group (block params sharded on their leading stacked dim:
    ``shard_pipeline_params``), each the fused ``fno_block``;
  * the batch is split into M micro-batches; at tick t stage s runs
    micro-batch t - s, receiving it from stage s - 1 and sending its
    output to stage s + 1;
  * the encoder and decoder (cheap 1x1 convs, replicated params) run on
    the first and the last stage, one micro-batch at a time, and the last
    stage's output is broadcast, so every rank returns the whole output,
    as the reference's final ``psum`` leaves it;
  * bubble fraction = (P-1)/(M+P-1) (``bubble_efficiency``).

Two departures from the reference, neither visible in the outputs:

  * the reference runs ``fno_block`` on zeros during bubble ticks and
    discards the results; here a stage runs its block only on ticks that
    carry a micro-batch, so each stage launches exactly M block forwards;
  * activations move between stages as host tensors on purpose (device ->
    host copy, gloo ``send``/``recv``, host -> device copy): gloo's
    point-to-point calls take a tensor's memory as host memory, unlike its
    collectives, which stage CUDA tensors themselves (a CUDA tensor's
    ``send`` aborts with "writev: Bad address").

Where the stages share cards (fewer CUDA devices than stages), each
stage hands its cached device memory back after every block and every
backward move (``torch.cuda.empty_cache``): a stage idle at a tick would
otherwise keep what its last block reserved, and the busy stages need it.

Differentiable. Each move is an autograd Function whose backward moves
the cotangent the other way, and the moves of one stage are chained (each
takes an empty "link" tensor from the one before), so every stage runs
its backward moves in the reverse of its forward order. The final
broadcast's backward passes the loss's cotangent to the last stage once:
every rank computes the same loss from the same output, and the other
ranks' copies are dropped, not summed (a sum would give P times the
gradient). So each stage holds the gradient of its own block, the first
stage the encoder's and the last the decoder's; ``reduce_pipeline_grads``
sums the replicated leaves over the group, which gives every rank the
serial gradient of each.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.core.fno import FNOConfig, _block_slice, _decoder, _encoder, fno_block
from repro_torch.core.partition import CartPartition, shard_tree

# Every block leaf [n_blocks, ...] is sharded on its stacked dim over the
# stage group; the encoder and decoder are replicated.
_STAGE = "model"


def pipeline_param_partitions() -> dict:
    return {
        "encoder": {"w": None, "b": None},
        "blocks": {"w_spec": CartPartition((_STAGE,) + (None,) * 6),
                   "w_bypass": CartPartition((_STAGE, None, None)),
                   "b_bypass": CartPartition((_STAGE, None))},
        "decoder": {"w1": None, "b1": None, "w2": None, "b2": None},
    }


def shard_pipeline_params(params: dict, group) -> dict:
    """This stage's parameters: block s of every block leaf (a copy, with
    its stacked dim of size 1), the encoder and decoder as they are."""
    local = shard_tree(params, pipeline_param_partitions(), {_STAGE: group})
    # a slice of the stacked dim is already contiguous, so ``shard`` returns
    # a view that would keep every stage's block alive
    local["blocks"] = {k: v.clone() for k, v in local["blocks"].items()}
    return local


@torch.no_grad()
def reduce_pipeline_grads(grads: dict, group) -> None:
    """Sum the encoder's and decoder's gradients over the stage group, in
    place: one stage holds each, so every rank then holds the serial one."""
    for name in ("encoder", "decoder"):
        for g in grads[name].values():
            dist.all_reduce(g, group=group)


def _peer(group, rank: int) -> int:
    return dist.get_global_rank(group, rank)


def _send(t: torch.Tensor, dst: int, group) -> None:
    dist.send(t.detach().to("cpu").contiguous(), _peer(group, dst), group=group)


def _recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    buf = torch.empty(shape, dtype=dtype)
    dist.recv(buf, _peer(group, src), group=group)
    return buf.to(device)


def _release(share: bool) -> None:
    if share:
        torch.cuda.empty_cache()


class _Recv(torch.autograd.Function):
    """Receive a micro-batch from stage ``src``; backward sends its
    cotangent back there."""

    @staticmethod
    def forward(ctx, link, shape, dtype, device, src, group, share):
        ctx.route, ctx.share = (src, group), share
        return _recv(shape, dtype, device, src, group), link.new_empty(0)

    @staticmethod
    def backward(ctx, g, g_link):
        _send(g, *ctx.route)
        _release(ctx.share)
        return g_link, None, None, None, None, None, None


class _Send(torch.autograd.Function):
    """Send a stage's output to stage ``dst``; backward receives the
    cotangent from there."""

    @staticmethod
    def forward(ctx, y, link, dst, group, share):
        ctx.route, ctx.share = (y.shape, y.dtype, y.device, dst, group), share
        _send(y, dst, group)
        return link.new_empty(0)

    @staticmethod
    def backward(ctx, g_link):
        _release(ctx.share)
        return _recv(*ctx.route), g_link, None, None, None


class _Replicate(torch.autograd.Function):
    """Broadcast the last stage's output over the group; backward takes the
    cotangent once, on the last stage."""

    @staticmethod
    def forward(ctx, out, link, last, group):
        ctx.is_last = dist.get_rank(group) == last
        ctx.link_device = link.device
        out = out.clone()
        dist.broadcast(out, _peer(group, last), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else None), torch.empty(0, device=ctx.link_device), None, None


def _timed(fn, device, trace: Optional[list], key: str, rec: dict):
    """fn(), with its wall time (device synchronised) in ``rec[key]`` when
    tracing."""
    if trace is None:
        return fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec[key] = time.perf_counter() - t0
    return out


def make_pipeline_forward(cfg: FNOConfig, group, *, n_micro: int):
    """The pipeline forward over ``group`` (the stage group: the model
    group of a (1 x P) layout, ``launch.mesh.build_fno_groups``):
    ``fwd(local_params, x, trace=None) -> y``, every rank calling it with
    its ``shard_pipeline_params`` and the whole batch x; every rank
    returns the whole output. Needs ``cfg.n_blocks`` == the group's size
    and a batch that ``n_micro`` divides. With a list ``trace``, each tick
    appends ``{"tick", "micro", "recv_s", "block_s", "send_s"}`` (device
    synchronised around each part) and the call appends ``{"wall_s"}``.
    """
    if group is None:
        raise ValueError("the stage group is None, which torch.distributed reads as every "
                         "rank; pass the model group build_fno_groups returns")
    p = dist.get_world_size(group)
    if cfg.n_blocks != p:
        raise ValueError(f"pipeline needs n_blocks == stages ({cfg.n_blocks} != {p})")

    def forward(local_params: dict, x: torch.Tensor, trace: Optional[list] = None):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"pipeline needs batch % n_micro == 0 {(b, n_micro)}")
        stage, device = dist.get_rank(group), x.device
        mb = b // n_micro
        shape = (mb, cfg.width) + tuple(cfg.grid)
        blk = _block_slice(local_params["blocks"], 0)
        grad = torch.is_grad_enabled()

        def block(h):
            return fno_block(h, blk["w_spec"], blk["w_bypass"], blk["b_bypass"], cfg)

        def decode(y):
            return _decoder(local_params, y, cfg)

        if grad and cfg.remat:
            # as _run_blocks: each block recomputed in the backward; the last
            # stage's decoder too, whose 128-channel hidden state would
            # otherwise be kept for every micro-batch at once
            run_block = partial(checkpoint, block, use_reentrant=False)
            run_decoder = partial(checkpoint, decode, use_reentrant=False)
        else:
            run_block, run_decoder = block, decode
        share = device.type == "cuda" and torch.cuda.device_count() < p
        link = torch.empty(0, device=device, requires_grad=grad)
        outs = []
        t_start = time.perf_counter()
        for t in range(n_micro + p - 1):
            m = t - stage
            rec = {"tick": t, "micro": m if 0 <= m < n_micro else None}
            if trace is not None:
                trace.append(rec)
            if rec["micro"] is None:
                continue
            if stage == 0:
                inp = _encoder(local_params, x[m * mb:(m + 1) * mb], cfg)
            else:
                inp, link = _timed(lambda: _Recv.apply(link, shape, cfg.dtype, device,
                                                       stage - 1, group, share),
                                   device, trace, "recv_s", rec)
            y = _timed(lambda: run_block(inp), device, trace, "block_s", rec)
            if stage < p - 1:
                link = _timed(lambda: _Send.apply(y, link, stage + 1, group, share),
                              device, trace, "send_s", rec)
            else:
                outs.append(run_decoder(y))
            del inp, y
            _release(share)
        if stage == p - 1:
            out = torch.cat(outs)
        else:
            out = torch.empty((b, cfg.out_channels) + tuple(cfg.grid), device=device)
        if trace is not None:
            trace.append({"wall_s": time.perf_counter() - t_start})
        return _Replicate.apply(out, link, p - 1, group)

    return forward


def bubble_efficiency(p: int, n_micro: int) -> float:
    """Ideal GPipe parallel efficiency: M / (M + P - 1)."""
    return n_micro / (n_micro + p - 1)
