"""Mixture-of-Experts: routing, capacity dispatch, expert FFNs, combine.

Port of the local path of ``repro.models.moe`` (``moe.py:42-190``):
``init_moe_params``, ``_route``, the load-balance statistics, ``_dispatch``,
``_combine``, ``_expert_ffn``, ``_capacity``, ``_moe_local`` and
``moe_apply`` with DeepSeek's shared experts. ``moe_apply`` returns the
reference's ``(y, aux)``: the output and the load-balance loss times
``aux_coef`` (from this call's routes, differentiable through the router
probabilities), which training adds to the loss and serving drops. The
expert-parallel all-to-all (``_moe_ep_shard``) waits with the distributed
LM paths (ROADMAP Queue 1 item 5d); ``moe_apply`` runs on one device.

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

from repro_torch.configs.base import NOT_PORTED, MoEConfig
from repro_torch.models import layers


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


def _dispatch(x_flat, topi, capacity: int, n_experts: int):
    """Scatter tokens into per-expert capacity buffers.

    Returns (buf [E, C, D], entry_expert [T*k], entry_pos [T*k], keep
    [T*k]). Entries are taken token-major; an entry's position is the
    number of earlier entries routed to its expert, and an entry at or past
    ``capacity`` is dropped (its token gets nothing from that expert)."""
    t, k = topi.shape
    d = x_flat.shape[-1]
    e_flat = topi.reshape(-1)
    onehot = F.one_hot(e_flat, n_experts)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, e_flat[:, None])[:, 0]
    keep = pos < capacity
    # dropped entries all go to one spare row past the buffers
    slot = torch.where(keep, e_flat * capacity + pos, n_experts * capacity)
    buf = x_flat.new_zeros((n_experts * capacity + 1, d))
    buf[slot] = x_flat.repeat_interleave(k, dim=0)
    return buf[:-1].reshape(n_experts, capacity, d), e_flat, pos, keep


def _combine(y_buf, e_flat, pos, keep, topv, t: int, capacity: int):
    """Gather each entry's expert output and mix a token's k entries with
    its router weights (a dropped entry weighs 0); [T, D]."""
    k = topv.shape[-1]
    d = y_buf.shape[-1]
    slot = torch.where(keep, e_flat * capacity + pos, 0)
    gathered = y_buf.reshape(-1, d)[slot]
    w = (topv.reshape(-1) * keep).to(gathered.dtype)
    return (gathered * w[:, None]).reshape(t, k, d).float().sum(dim=1).to(gathered.dtype)


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


def moe_apply(params: dict, x, moe: MoEConfig, *, dropless: bool = False, expert_group=None):
    """Routed experts plus shared experts. x: [b, s, d] -> (y, aux), aux
    the load-balance loss times ``moe.aux_coef`` (float32 scalar).

    ``dropless`` gives every expert room for all b*s tokens: a batch of
    tokens that the reference routes one at a time (its decode, one slot
    a step under ``vmap``, where a capacity of 1 drops nothing) keeps every
    entry whatever the batch. Otherwise the capacity is ``_capacity``'s, and
    entries past it drop as in the reference's prefill and training.

    One device only: an ``expert_group`` to spread the experts over (the
    reference's expert-parallel all-to-all dispatch) is refused."""
    if expert_group is not None:
        raise NotImplementedError(f"expert-parallel MoE (the all-to-all dispatch): {NOT_PORTED}")
    y, aux = _moe_local(params, x, moe, dropless)
    if "shared" in params:
        sh = params["shared"]
        y = y + layers.glu_mlp(x, sh["w_gate"], sh["w_up"], sh["w_down"], act="swiglu")
    return y, aux * moe.aux_coef
