"""RG-LRU recurrent mixer (Griffin / RecurrentGemma): prefill scan and decode.

Port of ``repro.models.rglru`` (``rglru.py:30-107``): ``init_rglru_params``,
``_rglru_scan``, ``rglru_forward``, ``init_rglru_cache`` and
``rglru_decode`` (its ``_causal_conv`` is ``layers.causal_conv``). Two
input projections: one branch goes through a depthwise causal conv and
the RG-LRU, the other is a tanh-GeLU gate; their product goes through the
output projection. The diagonal recurrence

    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t),  a_t = exp(-c softplus(L) r_t)

is a first-order linear recurrence. The reference runs it with
``jax.lax.associative_scan`` (XLA, no Pallas kernel); the port runs the
same combine as a log-depth scan, ceil(log2 s) rounds of whole-tensor
operations, so a prompt costs a few dozen launches a layer, not one a
token. Its sums associate in another order than XLA's tree, so the two
agree to float32 rounding, not bitwise.

The cache {"conv": [b, k, w] (the last k pre-conv inputs), "h": [b, w]} is
float32; ``rglru_decode`` updates it in place.

Over a model group the mixer is replicated, as the reference's specs keep
it: every rank holds its leaves whole and runs it on the whole stream,
with no collective and no ``copy_to`` (each rank's gradient is then the
whole of it; a ``copy_to`` would count it P times). Under ``seq_shard``
the recurrence needs the whole sequence: the ranks' slices are gathered
(``gather_from``), every rank runs the mixer on all of it and keeps its
slice of the output (``scatter_to``, whose backward gathers the whole
cotangent back). Its decode cache is whole on every rank too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import gather_from, scatter_to
from repro_torch.models import layers

RGLRU_C = 8.0


def init_rglru_params(d_model: int, cfg, normal, const, uniform) -> dict:
    """The mixer's leaves with the reference's shapes and scales;
    ``normal(name, shape, std)``, ``const(name, shape, value)`` and
    ``uniform(name, shape, lo, hi, fn)`` (``fn`` applied to the draw) make
    (and finish) a leaf."""
    w = cfg.width(d_model)
    std = d_model ** -0.5
    # lambda so that a^(1/c) ~ U[0.9, 0.999], as in the Griffin paper:
    # softplus^-1(-log u)
    return {
        "w_x": normal("w_x", (d_model, w), std),
        "w_gate": normal("w_gate", (d_model, w), std),
        "conv_w": normal("conv_w", (cfg.conv_kernel, w), 0.1),
        "conv_b": const("conv_b", (w,), 0.0),
        "w_r": normal("w_r", (w, w), w ** -0.5),
        "b_r": const("b_r", (w,), 0.0),
        "w_i": normal("w_i", (w, w), w ** -0.5),
        "b_i": const("b_i", (w,), 0.0),
        "lambda": uniform("lambda", (w,), 0.9, 0.999,
                          lambda u: torch.log(torch.expm1(-torch.log(u)))),
        "w_out": normal("w_out", (w, d_model), w ** -0.5),
    }


def _gates(x, r, i, lam):
    """(a, sqrt(1 - a^2) (i * x)) of the recurrence, float32."""
    log_a = -RGLRU_C * F.softplus(lam) * r
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x)
    return torch.exp(log_a), gated


def _rglru_scan(x, r, i, lam):
    """x/r/i: [b, s, w] float32; lam: [w]. Returns h: [b, s, w].

    An inclusive scan of (a_t, g_t) under the reference's combine
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r), in Hillis-Steele
    rounds: round k combines each position with the one 2^k before it."""
    a, h = _gates(x, r, i, lam)
    s, d = x.shape[1], 1
    while d < s:
        h = torch.cat([h[:, :d], h[:, :-d] * a[:, d:] + h[:, d:]], dim=1)
        if 2 * d < s:  # the last round's products of a are never read
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return h


def rglru_forward(params: dict, x, cfg, d_model: int, *, return_cache: bool = False,
                  seq_group=None):
    """x: [b, s, d] -> [b, s, d]; with ``return_cache`` also the decode
    cache {"conv": the last k pre-conv inputs (left-padded with zeros for a
    prompt shorter than k), "h": the last float32 state}, from this one
    scan (the reference scans a second time for the same numbers).
    ``seq_group``: the model group when x is this rank's slice of the
    sequence; the output is then this rank's slice too, the cache the
    whole sequence's."""
    if seq_group is not None:
        x = gather_from(x, 1, seq_group)
    gate = F.gelu(x @ params["w_gate"].to(x.dtype), approximate="tanh")
    u = x @ params["w_x"].to(x.dtype)
    uf = layers.causal_conv(u, params["conv_w"], params["conv_b"]).float()
    r = torch.sigmoid(uf @ params["w_r"] + params["b_r"])
    i = torch.sigmoid(uf @ params["w_i"] + params["b_i"])
    hseq = _rglru_scan(uf, r, i, params["lambda"])
    y = (hseq.to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    if seq_group is not None:
        y = scatter_to(y, 1, seq_group)
    if not return_cache:
        return y
    k = params["conv_w"].shape[0]
    conv = F.pad(u[:, -k:], (0, 0, max(0, k - u.shape[1]), 0)).float()
    return y, {"conv": conv, "h": hseq[:, -1]}


# -- decode -------------------------------------------------------------------

def cache_shapes(d_model: int, cfg, batch: int) -> dict:
    w = cfg.width(d_model)
    return {"conv": (batch, cfg.conv_kernel, w), "h": (batch, w)}


def init_rglru_cache(d_model: int, cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in cache_shapes(d_model, cfg, batch).items()}


def rglru_decode(params: dict, x, cache: dict, cfg, d_model: int):
    """One recurrent step for every row. x: [b, 1, d]; the cache is updated
    in place. As the reference: the rolling conv, the gates and the state
    in float32 with the float32 conv and gate weights. Returns (out [b, 1,
    d], cache)."""
    gate = F.gelu(x[:, 0] @ params["w_gate"].to(x.dtype), approximate="tanh")
    u = x[:, 0] @ params["w_x"].to(x.dtype)
    conv = torch.cat([cache["conv"][:, 1:], u[:, None].to(cache["conv"].dtype)], dim=1)
    u = torch.einsum("bkc,kc->bc", conv.float(), params["conv_w"].float()) + params["conv_b"]
    r = torch.sigmoid(u @ params["w_r"] + params["b_r"])
    i = torch.sigmoid(u @ params["w_i"] + params["b_i"])
    a, gated = _gates(u, r, i, params["lambda"])
    h = a * cache["h"] + gated
    y = (h.to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    cache["conv"].copy_(conv)
    cache["h"].copy_(h)
    return y[:, None], cache
