"""Mamba-2 (SSD, state-space duality) mixer: chunked prefill and recurrent decode.

Port of ``repro.models.ssm`` (``ssm.py:48-246``): ``init_ssm_params``,
``ssd_chunked``, ``_project``, ``ssm_forward`` (with ``return_cache``),
``init_ssm_cache`` and ``ssm_decode`` (its ``_causal_conv`` is
``layers.causal_conv``). The prefill runs the SSD chunked algorithm:
within a chunk, (chunk x N) x (N x chunk) products weighted by the decay
between positions; across chunks, a recurrence over the chunk-final
states, which the reference runs with ``lax.scan`` and the port as a
Python loop over at most s / chunk chunks. Decode keeps the O(1)
recurrent state.

Every product here is plain PyTorch, as the reference computes its einsums
outside any Pallas kernel. Its three-operand einsums run as two explicit
contractions, so no [b, c, i, j, h, p] intermediate is formed. The gated
RMSNorm runs through the port's RMSNorm kernel (its plain version for CPU
tensors).

Over a model group of P > 1 ranks (``group``) the mixer is
tensor-parallel over its heads, with the reference's specs: a rank holds
its d_inner/P columns of w_z, w_x, conv_x, conv_bx and norm_w and its rows
of out_proj, and computes its H/P heads: z and x from its columns, B, C
and dt from the whole w_B, w_C and w_dt (its heads' slice of dt, A_log, D
and dt_bias). Each rank uses those whole leaves (``WHOLE_LEAVES``) on its
own heads only, so they enter through ``copy_to``, which sums their
gradient's parts over the group. The gated norm's mean of squares spans
the whole d_inner: each rank sums the squares of its columns and the group
sums those (``sum_copies``: every rank uses the total on its own columns,
so the backward sums their cotangents too); the split norm runs in plain
ops, so it launches no kernel. out_proj's partial products are summed over
the group (``layers.tp_out``). The decode state is this rank's heads; the
conv cache keeps the whole (x | B | C) pre-conv stream on every rank (the
reference's ``cache_specs``), each step's x columns all-gathered into it.

Shapes per Mamba-2: d_inner = expand * d_model, heads H = d_inner /
head_dim, state N = d_state, B and C shared across heads (n_groups = 1).
The projections are stored split (w_z, w_x, w_B, w_C, w_dt) as in the
reference. The cache {"conv": [b, k, conv_dim], "state": [b, H, N, p]} is
float32; ``ssm_decode`` updates it in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import copy_to, gather_from, reduce_from, sum_copies
from repro_torch.models import layers

# the leaves a rank holds whole over a model group and uses on its own heads
WHOLE_LEAVES = ("w_B", "w_C", "w_dt", "conv_B", "conv_C", "conv_bB", "conv_bC", "A_log", "D",
                "dt_bias")


def init_ssm_params(d_model: int, ssm, normal, const) -> dict:
    """The mixer's leaves with the reference's shapes, scales and constant
    initialisers; ``normal(name, shape, std)`` and ``const(name, shape,
    value)`` (a float or a tensor of ``shape``) make (and finish) a leaf."""
    di = ssm.d_inner(d_model)
    h = ssm.n_heads(d_model)
    gn = ssm.n_groups * ssm.d_state
    k = ssm.conv_kernel
    std = d_model ** -0.5
    return {
        "w_z": normal("w_z", (d_model, di), std),
        "w_x": normal("w_x", (d_model, di), std),
        "w_B": normal("w_B", (d_model, gn), std),
        "w_C": normal("w_C", (d_model, gn), std),
        "w_dt": normal("w_dt", (d_model, h), std),
        "conv_x": normal("conv_x", (k, di), 0.1),
        "conv_B": normal("conv_B", (k, gn), 0.1),
        "conv_C": normal("conv_C", (k, gn), 0.1),
        "conv_bx": const("conv_bx", (di,), 0.0),
        "conv_bB": const("conv_bB", (gn,), 0.0),
        "conv_bC": const("conv_bC", (gn,), 0.0),
        "A_log": const("A_log", (h,), torch.log(torch.linspace(1.0, 16.0, h))),
        "D": const("D", (h,), 1.0),
        "dt_bias": const("dt_bias", (h,), math.log(math.expm1(0.01))),  # softplus^-1(0.01)
        "norm_w": const("norm_w", (di,), 1.0),
        "out_proj": normal("out_proj", (di, d_model), di ** -0.5),
    }


def ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk: int, *, return_state: bool = False):
    """SSD scan. x: [b, s, h, p]; dt: [b, s, h] (post-softplus); a_log:
    [h]; b_mat/c_mat: [b, s, n] (group-shared). Returns y [b, s, h, p]
    float32 (and the final state [b, h, n, p] with ``return_state``).
    Recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t; y_t = C_t . h_t.

    The decay exp(cs_i - cs_j) above the diagonal (j > i) can overflow to
    inf; it is replaced by 0 with ``where`` before any product, as the
    reference does, so no inf * 0 reaches the sums."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    a = -torch.exp(a_log.float())                      # [h], negative
    dtf = dt.float()
    da = dtf * a                                       # [b, s, h]
    xf = x.float() * dtf[..., None]                    # discretized input
    cs = torch.cumsum(da.reshape(bsz, nc, chunk, h), dim=2)  # inclusive within a chunk
    x_c = xf.reshape(bsz, nc, chunk, h, p)
    b_c = b_mat.float().reshape(bsz, nc, chunk, n)
    c_c = c_mat.float().reshape(bsz, nc, chunk, n)

    # intra-chunk: scores[i, j] = (C_i . B_j) exp(cs_i - cs_j), j <= i
    scores = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])  # [b, c, i, j, h]
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tril[None, None, :, :, None], decay, 0.0)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, x_c)

    # chunk-final states: S[c] = sum_j B_j exp(cs_last - cs_j) x_j
    d2e = torch.exp(cs[:, :, -1:, :] - cs)             # [b, c, j, h]
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", b_c, x_c * d2e[..., None])
    total = torch.exp(cs[:, :, -1, :])                 # [b, c, h], a full chunk's decay

    # inter-chunk recurrence; each chunk reads the state before it
    s_run = torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
    s_prev = []
    for c in range(nc):
        s_prev.append(s_run)
        s_run = s_run * total[:, c, :, None, None] + s_chunk[:, c]
    s_prev = torch.stack(s_prev, dim=1)                # [b, c, h, n, p]
    y_inter = torch.einsum("bcin,bchnp->bcihp", c_c, s_prev) * torch.exp(cs)[..., None]
    y = (y + y_inter).reshape(bsz, s, h, p)
    return (y, s_run) if return_state else y


def _project(params, x):
    dt = x.dtype
    return tuple(x @ params[name].to(dt) for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _on_rank(params: dict, group, head_dim: int) -> dict:
    """The leaves as this rank uses them over a model group: its shards as
    held, the whole leaves through ``copy_to``, and of the per-head ones
    (w_dt's columns, A_log, D, dt_bias) its heads' slice."""
    p = dict(params)
    for name in WHOLE_LEAVES:
        p[name] = copy_to(p[name], group)
    n = p["w_x"].shape[-1] // head_dim
    heads = slice(group.rank() * n, (group.rank() + 1) * n)
    p["w_dt"] = p["w_dt"][:, heads]
    for name in ("A_log", "D", "dt_bias"):
        p[name] = p[name][heads]
    return p


def _gated_norm(g, w, width: int, group):
    """RMSNorm of the gated output g [..., n] over the whole inner width:
    through the RMSNorm kernel when g holds every column, else (g this
    rank's columns over ``group``) in plain ops with the group's sum of
    squares, f32 statistics as the kernel's."""
    if group is None:
        return layers.rms_norm(g, w)
    gf = g.float()
    ms = sum_copies(gf.square().sum(dim=-1, keepdim=True), group) / width
    return (gf * torch.rsqrt(ms + 1e-6) * w.float()).to(g.dtype)


def ssm_forward(params: dict, x, d_model: int, ssm, *, return_cache: bool = False, group=None,
                seq_sharded: bool = False):
    """Full-sequence Mamba-2 mixer. x: [b, s, d] -> [b, s, d]; with
    ``return_cache`` also the decode cache {"conv": the last k pre-conv
    columns of (x | B | C), left-padded with zeros for a prompt shorter
    than k, "state": the final SSD state}, both float32.

    ``group``: the model group (P > 1) over which ``params`` are this
    rank's shards; x is the residual stream as the block holds it (this
    rank's slice of the sequence with ``seq_sharded``), and the state
    returned holds this rank's heads."""
    if group is not None:
        params = _on_rank(params, group, ssm.head_dim)
        x = layers.tp_in(x, group, seq_sharded)
    b, s, _ = x.shape
    di = params["w_x"].shape[-1]  # this rank's inner columns
    h = di // ssm.head_dim
    z, xs, b_mat, c_mat, dt = _project(params, x)
    pre = (xs, b_mat, c_mat)  # the pre-conv streams the decode's conv cache keeps
    xs = F.silu(layers.causal_conv(xs, params["conv_x"], params["conv_bx"]))
    b_mat = F.silu(layers.causal_conv(b_mat, params["conv_B"], params["conv_bB"]))
    c_mat = F.silu(layers.causal_conv(c_mat, params["conv_C"], params["conv_bC"]))
    dt = F.softplus(dt.float() + params["dt_bias"])
    # pad the sequence to a chunk multiple with dt = 0 steps: decay exp(0) = 1
    # and a zero discretized input leave the state untouched, so the final
    # state is exact; the padded outputs are sliced off
    chunk = min(ssm.chunk, s)
    pad = (-s) % chunk
    xs_p, b_p, c_p, dt_p = (F.pad(t, (0, 0, 0, pad)) for t in (xs, b_mat, c_mat, dt))
    out = ssd_chunked(xs_p.reshape(b, s + pad, h, ssm.head_dim), dt_p, params["A_log"], b_p, c_p,
                      chunk, return_state=return_cache)
    y, state = out if return_cache else (out, None)
    y = y[:, :s] + params["D"][None, None, :, None] * xs.reshape(b, s, h, ssm.head_dim).float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(y * F.silu(z), params["norm_w"], ssm.d_inner(d_model), group)
    y = y @ params["out_proj"].to(x.dtype)
    if group is not None:
        y = layers.tp_out(y, group, seq_sharded)
    if not return_cache:
        return y
    k = ssm.conv_kernel
    if group is not None:  # the whole x stream: every rank's columns
        pre = (gather_from(pre[0][:, -k:], -1, group),) + pre[1:]
    conv = torch.cat([F.pad(t[:, -k:], (0, 0, max(0, k - s), 0)) for t in pre], dim=-1)
    return y, {"conv": conv.float(), "state": state}


# -- decode -------------------------------------------------------------------

def init_ssm_cache(d_model: int, ssm, batch: int, dtype=torch.float32, device=None) -> dict:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in cache_shapes(d_model, ssm, batch).items()}


def cache_shapes(d_model: int, ssm, batch: int) -> dict:
    h = ssm.n_heads(d_model)
    return {"conv": (batch, ssm.conv_kernel, ssm.conv_dim(d_model)),
            "state": (batch, h, ssm.d_state, ssm.head_dim)}


def ssm_decode(params: dict, x, cache: dict, d_model: int, ssm, *, group=None):
    """Single-token recurrent step for every row. x: [b, 1, d]; the cache
    is updated in place. As the reference: the rolling conv in float32
    with the float32 conv weights, the state update and readout in
    float32. Returns (out [b, 1, d], cache).

    ``group``: the model group (P > 1) over which ``params`` are this
    rank's shards and the cache's state its heads; its conv cache is whole,
    this step's x columns all-gathered into it."""
    if group is not None:
        params = _on_rank(params, group, ssm.head_dim)
    b = x.shape[0]
    di = params["w_x"].shape[-1]  # this rank's inner columns
    h = di // ssm.head_dim
    gn = ssm.n_groups * ssm.d_state
    z, xs, b_mat, c_mat, dt = _project(params, x[:, 0])
    # rolling conv state over the concatenated (x | B | C) pre-conv stream
    xs_all = xs if group is None else gather_from(xs, -1, group)
    new_col = torch.cat([xs_all, b_mat, c_mat], dim=-1)
    conv = torch.cat([cache["conv"][:, 1:], new_col[:, None].to(cache["conv"].dtype)], dim=1)
    mine = conv
    if group is not None:  # this rank's x columns, then B and C
        lo, width = group.rank() * di, xs_all.shape[-1]
        mine = torch.cat([conv[..., lo:lo + di], conv[..., width:]], dim=-1)
    conv_w = torch.cat([params["conv_x"], params["conv_B"], params["conv_C"]], dim=1)
    conv_b = torch.cat([params["conv_bx"], params["conv_bB"], params["conv_bC"]])
    mixed = torch.einsum("bkc,kc->bc", mine.float(), conv_w.float()) + conv_b
    mixed = F.silu(mixed).to(x.dtype)
    xs, b_mat, c_mat = torch.split(mixed, [di, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])  # [b, h]
    decay = torch.exp(dt * -torch.exp(params["A_log"]))
    xh = xs.reshape(b, h, ssm.head_dim).float()
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", b_mat.float(), xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", c_mat.float(), state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, di).to(x.dtype)
    y = _gated_norm(y * F.silu(z), params["norm_w"], ssm.d_inner(d_model), group)
    cache["conv"].copy_(conv)
    cache["state"].copy_(state)
    return reduce_from(y @ params["out_proj"].to(x.dtype), group)[:, None], cache
