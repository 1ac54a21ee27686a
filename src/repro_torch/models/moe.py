"""Mixture-of-Experts: routing, capacity dispatch, expert FFNs, combine.

Port of ``repro.models.moe`` (``moe.py:42-234``): ``init_moe_params``,
``moe_param_specs``, ``_route``, the load-balance statistics,
``_dispatch``, ``_combine``, ``_expert_ffn``, ``_capacity``,
``_moe_local``, the expert-parallel ``_moe_ep_shard`` and ``moe_apply``
with DeepSeek's shared experts. ``moe_apply`` returns the reference's
``(y, aux)``: the output and the load-balance loss times ``aux_coef``
(differentiable through the router probabilities), which training adds to
the loss and serving drops.

Under a mesh policy (``models/policy.py``) the reference's condition picks
the expert-parallel path: P > 1 model ranks, P dividing the sequence and
the experts. Each (data, model) rank
then routes its own tokens (its rows, its slice of the sequence) with its
own capacity, one all-to-all over the model group sends every expert's
buffer to the rank that holds it ([E, C, d] -> [E/P, P C, d]: the paper's
repartition on the expert dim), the experts run there, and the reverse
all-to-all brings the results home; the load-balance loss comes from the
routing statistics summed over every rank. Where that condition fails (a
decode step, which routes dropless; a prompt or training sequence that P
does not divide; a data-only mesh, P = 1) the path is the reference's
``_moe_local`` on the global batch, as its jit routes it
(``_moe_together``): the data ranks route their tokens together, the
capacity that of the global token count, each entry's place in its
expert's buffer counting the entries of the lower data ranks
(``_dispatch``'s ``before``), the statistics summed over the data group;
every rank of a model group routes and dispatches the same tokens, runs
its E/P experts' buffers, and the group sums the partial outputs (in
f32, rounded once). The shared experts run tensor-parallel
(``layers.tp_mlp``).

No [T, E, C] one-hot tensor is formed: an entry's position in its
expert's buffer is an exclusive cumulative count over the token-major
[T*k, E] assignment, so the entries past an expert's capacity are dropped
exactly as the reference drops them. The three batched expert products are
plain matrix products (the reference leaves them to XLA), here
``torch.einsum`` over the [E, C, d] buffer.

Precision, as the reference: router logits in the activation dtype, then
an f32 softmax; top-k of the probabilities with ties to the lower expert
index (``jax.lax.top_k``'s order, which ``torch.topk`` does not promise:
here a stable descending sort); router weights cast to the activation
dtype; the per-token sum over its k experts taken in f32 and rounded once
(``jnp.sum`` of bf16 accumulates in f32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.collectives import (
    all_reduce_sum, copy_to, gather_from, reduce_from, scatter_to, sum_copies,
)
from repro_torch.core.partition import gather_dim
from repro_torch.core.repartition import repartition
from repro_torch.models import layers
from repro_torch.models.policy import LOCAL, MODEL_AXIS


def init_moe_params(d_model: int, moe: MoEConfig, normal) -> dict:
    """The routed (and shared) experts' weights with the reference's leaves
    and scales; ``normal(name, shape, std)`` draws (and finishes) a leaf."""
    e, f = moe.n_experts, moe.d_expert
    std_d, std_f = d_model ** -0.5, f ** -0.5
    p = {
        "router": normal("router", (d_model, e), std_d),
        "w_gate": normal("w_gate", (e, d_model, f), std_d),
        "w_up": normal("w_up", (e, d_model, f), std_d),
        "w_down": normal("w_down", (e, f, d_model), std_f),
    }
    if moe.n_shared:
        fs = moe.n_shared * f
        p["shared"] = {
            "w_gate": normal("w_gate", (d_model, fs), std_d),
            "w_up": normal("w_up", (d_model, fs), std_d),
            "w_down": normal("w_down", (fs, d_model), fs ** -0.5),
        }
    return p


def moe_param_specs(moe: MoEConfig) -> dict:
    """The reference's specs as tuples: the experts split over the model
    axis, the shared experts column/row-parallel, the router whole."""
    p = {"router": (), "w_gate": (MODEL_AXIS, None, None), "w_up": (MODEL_AXIS, None, None),
         "w_down": (MODEL_AXIS, None, None)}
    if moe.n_shared:
        p["shared"] = {"w_gate": (None, MODEL_AXIS), "w_up": (None, MODEL_AXIS),
                       "w_down": (MODEL_AXIS, None)}
    return p


def _route(x_flat, router_w, moe: MoEConfig):
    """x_flat: [T, D] -> (top idx [T, k], top weights [T, k] in x's dtype,
    probs [T, E] f32). Equal probabilities keep the lower expert first."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, : moe.top_k], topi[:, : moe.top_k]
    if moe.norm_topk:
        topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
    return topi, topv.to(x_flat.dtype), probs


def _aux_stats(topi, probs, moe: MoEConfig):
    """Sufficient statistics of the load-balance loss: per-expert routing
    counts (a scatter of ones, which, unlike ``bincount``, does not wait
    for the device), summed probabilities, and the number of tokens."""
    flat = topi.reshape(-1)
    counts = torch.zeros(moe.n_experts, dtype=torch.float32, device=topi.device)
    counts.scatter_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=topi.device))
    return counts, probs.sum(dim=0), float(probs.shape[0])


def _aux_from_stats(counts, prob_sum, n, moe: MoEConfig):
    """GShard/switch load-balance loss: E * sum_e f_e * P_e."""
    f = counts / torch.clamp(counts.sum(), min=1.0)
    p = prob_sum / max(n, 1.0)
    return moe.n_experts * torch.sum(f * p)


def _aux_loss(topi, probs, moe: MoEConfig):
    return _aux_from_stats(*_aux_stats(topi, probs, moe), moe)


def _dispatch(x_flat, topi, capacity: int, n_experts: int, before=None):
    """Scatter tokens into per-expert capacity buffers.

    Returns (buf [E, C, D], entry_expert [T*k], entry_pos [T*k], keep
    [T*k]). Entries are taken token-major; an entry's position is the
    number of earlier entries routed to its expert, and an entry at or past
    ``capacity`` is dropped (its token gets nothing from that expert).
    ``before`` [E], if given, counts each expert's entries that come ahead
    of these (the lower data ranks'): they hold their places in the
    capacity, and C is then the most of it these entries can fill."""
    t, k = topi.shape
    d = x_flat.shape[-1]
    e_flat = topi.reshape(-1)
    onehot = F.one_hot(e_flat, n_experts)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, e_flat[:, None])[:, 0]
    if before is None:
        keep = pos < capacity
    else:
        keep = pos + before[e_flat] < capacity
        capacity = min(capacity, t * k)
    # dropped entries all go to one spare row past the buffers
    slot = torch.where(keep, e_flat * capacity + pos, n_experts * capacity)
    buf = x_flat.new_zeros((n_experts * capacity + 1, d))
    buf[slot] = x_flat.repeat_interleave(k, dim=0)
    return buf[:-1].reshape(n_experts, capacity, d), e_flat, pos, keep


def _combine(y_buf, e_flat, pos, keep, topv, t: int, capacity: int, f32: bool = False):
    """Gather each entry's expert output and mix a token's k entries with
    its router weights (a dropped entry weighs 0); [T, D], the f32 sum
    rounded to the buffer's dtype, or kept f32 with ``f32``."""
    k = topv.shape[-1]
    d = y_buf.shape[-1]
    slot = torch.where(keep, e_flat * capacity + pos, 0)
    gathered = y_buf.reshape(-1, d)[slot]
    w = (topv.reshape(-1) * keep).to(gathered.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).float().sum(dim=1)
    return y if f32 else y.to(gathered.dtype)


def _expert_ffn(buf, w_gate, w_up, w_down):
    """buf: [E, C, D]; weights [E, D, F] and [E, F, D]: each expert's
    SwiGLU on its own buffer."""
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate.to(buf.dtype)))
    u = torch.einsum("ecd,edf->ecf", buf, w_up.to(buf.dtype))
    return torch.einsum("ecf,efd->ecd", g * u, w_down.to(buf.dtype))


def _capacity(t: int, moe: MoEConfig) -> int:
    """Statistical capacity for large token counts; a dropless floor for
    small ones (t <= 128 tokens have room for all of them on one expert)."""
    statistical = math.ceil(t * moe.top_k / moe.n_experts * moe.capacity_factor)
    return max(1, statistical, min(t, 128))


def _moe_local(params, x, moe: MoEConfig, dropless: bool):
    """Single-device routed-experts pass. x: [b, s, d] -> (y, the
    load-balance loss of its routes)."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    topi, topv, probs = _route(x_flat, params["router"], moe)
    cap = t if dropless else _capacity(t, moe)
    buf, e_flat, pos, keep = _dispatch(x_flat, topi, cap, moe.n_experts)
    y_buf = _expert_ffn(buf, params["w_gate"], params["w_up"], params["w_down"])
    y = _combine(y_buf, e_flat, pos, keep, topv, t, cap).reshape(b, s, d)
    return y, _aux_loss(topi, probs, moe)


def _global_aux(topi, probs, moe: MoEConfig, policy):
    """The load-balance loss from the routing statistics summed over every
    rank of the mesh (each rank routes its own tokens), so it equals the
    one-device loss of all of them. The probabilities' sum carries the
    gradient: over the model group one loss among the ranks, over the data
    group each rank's term (``core/collectives.py``)."""
    counts, prob_sum, n = _aux_stats(topi, probs, moe)
    counts = all_reduce_sum(all_reduce_sum(counts, policy.model_group), policy.data_group)
    prob_sum = sum_copies(reduce_from(prob_sum, policy.model_group), policy.data_group)
    return _aux_from_stats(counts, prob_sum, n * policy.model_size() * policy.dp_size(), moe)


def _moe_ep_shard(params, x, moe: MoEConfig, policy):
    """The expert-parallel pass on this rank's token shard x [b, s/P, d]
    (its rows and its slice of the sequence) and its E/P experts' weights:
    all-to-all #1 [E, C, d] -> [E/P, P C, d] (experts home), all-to-all #2
    its adjoint (results back to the tokens' ranks). The capacity is this
    shard's, as the reference's shard_map computes it."""
    group = policy.model_group
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    # the router sees this rank's tokens only: its gradient here is a part
    topi, topv, probs = _route(x_flat, copy_to(params["router"], group), moe)
    cap = _capacity(t, moe)
    buf, e_flat, pos, keep = _dispatch(x_flat, topi, cap, moe.n_experts)
    buf = repartition(buf, 1, 0, group)
    y_buf = _expert_ffn(buf, params["w_gate"], params["w_up"], params["w_down"])
    y_buf = repartition(y_buf, 0, 1, group)
    y = _combine(y_buf, e_flat, pos, keep, topv, t, cap)
    return y.reshape(b, s, d), _global_aux(topi, probs, moe, policy)


def _moe_together(params, x, moe: MoEConfig, policy, dropless: bool):
    """The reference's ``_moe_local`` over a mesh (see the module's
    docstring): the data ranks' tokens routed as one batch, each rank
    running its E/P experts on every token its data rank holds, the model
    group summing the partial outputs. x [b, s, d] is whole on every rank
    of the model group."""
    group, data = policy.model_group, policy.data_group
    p, e = policy.model_size(), moe.n_experts
    if e % p:
        raise ValueError(f"{e} experts do not split over {p} model ranks")
    b, s, d = x.shape
    # every rank of the model group uses x and the router for its own
    # experts: their gradients here are parts, summed over the group
    x_flat = copy_to(x, group).reshape(-1, d)
    t = x_flat.shape[0]
    topi, topv, probs = _route(x_flat, copy_to(params["router"], group), moe)
    before = None
    if dropless:
        cap = t
    else:
        cap = _capacity(t * policy.dp_size(), moe)
        counts = torch.zeros(e, dtype=torch.long, device=x.device)
        counts.scatter_add_(0, topi.reshape(-1), torch.ones_like(topi.reshape(-1)))
        every = gather_dim(counts[None], 0, data) if data.size() > 1 else counts[None]
        before = every[:data.rank()].sum(dim=0)
    buf, e_flat, pos, keep = _dispatch(x_flat, topi, cap, e, before=before)
    lo = policy.model_rank() * (e // p)
    y_buf = _expert_ffn(buf[lo:lo + e // p], params["w_gate"], params["w_up"], params["w_down"])
    if p > 1:  # the other ranks' experts give nothing here
        y_buf = F.pad(y_buf, (0, 0, 0, 0, lo, e - lo - e // p))
    y = _combine(y_buf, e_flat, pos, keep, topv, t, buf.shape[1], f32=True)
    y = reduce_from(y, group).to(x.dtype).reshape(b, s, d)
    # the load-balance loss from the data ranks' statistics; the model
    # ranks hold the same routes, so one of them carries its gradient
    counts, prob_sum, n = _aux_stats(topi, probs, moe)
    if policy.model_rank():
        prob_sum = prob_sum.detach()
    counts = all_reduce_sum(counts, data)
    prob_sum = sum_copies(prob_sum, data)
    return y, _aux_from_stats(counts, prob_sum, n * policy.dp_size(), moe)


def moe_apply(params: dict, x, moe: MoEConfig, policy=LOCAL, *, dropless: bool = False,
              seq_sharded: bool = False):
    """Routed experts plus shared experts. x: [b, s, d] -> (y, aux), aux
    the load-balance loss times ``moe.aux_coef`` (float32 scalar).

    ``dropless`` gives every expert room for all b*s tokens: a batch of
    tokens that the reference routes one at a time (its decode, one slot
    a step under ``vmap``, where a capacity of 1 drops nothing) keeps every
    entry whatever the batch. Otherwise the capacity is ``_capacity``'s, and
    entries past it drop as in the reference's prefill and training.

    Under a mesh policy x is the residual stream as this rank holds it
    (its rows; its slice of the sequence with ``seq_sharded``) and
    ``params`` this rank's shards: the expert-parallel all-to-all on the
    reference's condition (P > 1 model ranks dividing the sequence and the
    experts, not ``dropless``), else ``_moe_together``
    (see the module's docstring)."""
    if not policy.distributed:
        y, aux = _moe_local(params, x, moe, dropless)
    else:
        size, group = policy.model_size(), policy.model_group
        s = x.shape[1] * (size if seq_sharded else 1)
        if not dropless and size > 1 and s % size == 0 and moe.n_experts % size == 0:
            xs = x if seq_sharded else scatter_to(x, 1, group)
            y, aux = _moe_ep_shard(params, xs, moe, policy)
            if not seq_sharded:
                y = gather_from(y, 1, group)
        else:
            y, aux = _moe_together(params, gather_from(x, 1, group) if seq_sharded else x, moe,
                                   policy, dropless)
            if seq_sharded:
                y = scatter_to(y, 1, group)
    if "shared" in params:
        sh = params["shared"]
        if policy.model_size() > 1:
            y = y + layers.tp_mlp(x, sh, "swiglu", policy.model_group, seq_sharded)
        else:
            y = y + layers.glu_mlp(x, sh["w_gate"], sh["w_up"], sh["w_down"], act="swiglu")
    return y, aux * moe.aux_coef
