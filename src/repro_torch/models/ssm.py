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

from repro_torch.models import layers


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


def ssm_forward(params: dict, x, d_model: int, ssm, *, return_cache: bool = False):
    """Full-sequence Mamba-2 mixer. x: [b, s, d] -> [b, s, d]; with
    ``return_cache`` also the decode cache {"conv": the last k pre-conv
    columns of (x | B | C), left-padded with zeros for a prompt shorter
    than k, "state": the final SSD state}, both float32."""
    b, s, _ = x.shape
    di = ssm.d_inner(d_model)
    h = ssm.n_heads(d_model)
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
    y = layers.rms_norm(y * F.silu(z), params["norm_w"])
    y = y @ params["out_proj"].to(x.dtype)
    if not return_cache:
        return y
    k = ssm.conv_kernel
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


def ssm_decode(params: dict, x, cache: dict, d_model: int, ssm):
    """Single-token recurrent step for every row. x: [b, 1, d]; the cache
    is updated in place. As the reference: the rolling conv in float32
    with the float32 conv weights, the state update and readout in
    float32. Returns (out [b, 1, d], cache)."""
    b = x.shape[0]
    di = ssm.d_inner(d_model)
    h = ssm.n_heads(d_model)
    gn = ssm.n_groups * ssm.d_state
    z, xs, b_mat, c_mat, dt = _project(params, x[:, 0])
    # rolling conv state over the concatenated (x | B | C) pre-conv stream
    new_col = torch.cat([xs, b_mat, c_mat], dim=-1)
    conv = torch.cat([cache["conv"][:, 1:], new_col[:, None].to(cache["conv"].dtype)], dim=1)
    conv_w = torch.cat([params["conv_x"], params["conv_B"], params["conv_C"]], dim=1)
    conv_b = torch.cat([params["conv_bx"], params["conv_bB"], params["conv_bC"]])
    mixed = torch.einsum("bkc,kc->bc", conv.float(), conv_w.float()) + conv_b
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
    y = layers.rms_norm(y * F.silu(z), params["norm_w"])
    cache["conv"].copy_(conv)
    cache["state"].copy_(state)
    return (y @ params["out_proj"].to(x.dtype))[:, None], cache
