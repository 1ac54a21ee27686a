"""Decoder-LM serving for the dense family: parameters, prefill, decode.

Port of the dense-family part of ``repro.models.transformer``:
``init_lm_params``, ``_norm``, the prefill layer, ``lm_prefill``,
``_attn_prefill``, ``init_cache``, ``_decode_layer`` and
``lm_decode_step``. Parameters keep the reference's tree and leaf names,
with the layers stacked on a leading layer dim::

    {"embed": [V, d], "final_norm": [d], "lm_head": [d, V], "layer0": None,
     "layers": {"ln1": [L, d], "attn": {"wq": [L, d, h*hd], ...},
                "ln2": [L, d], "mlp": {...}}}

and the reference's ``lax.scan`` over the stack is a Python loop over its
layer views. ``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry a
parameter tree across the two packages. Caches are stacked the same way,
{"layer0": None, "layers": {"k": [L, b, kvh, S, hd], "v": ...}}, and
``lm_decode_step`` updates them in place.

Every RMSNorm goes through the fused RMSNorm kernel and every prefill
attention through the flash-attention kernel (their plain versions for CPU
tensors): ``norms_per_forward(cfg)`` norms per prefill or decode step
(2 L + 1 without qk-norm) and L flash launches per prefill.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers

# leaves that stay float32 when the serving runner casts the rest to the
# activation dtype (the reference casts every other weight at its matmul)
F32_LEAVES = ("embed", "final_norm", "ln1", "ln2", "q_norm", "k_norm")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _normal(shape, std, generator, device):
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def _init_layers(cfg, generator, device) -> dict:
    """The stacked layer leaves, drawn one stacked leaf at a time."""
    n, d, hd = len(cfg.layer_kinds()), cfg.d_model, cfg.head_dim_
    h, kvh, f = cfg.n_heads, cfg.kv_heads, cfg.d_ff
    std_d, std_f = d ** -0.5, f ** -0.5

    def normal(*shape, std=std_d):
        return _normal((n,) + shape, std, generator, device)

    def const(value, *shape):
        return torch.full((n,) + shape, value, dtype=torch.float32, device=device)

    attn = {"wq": normal(d, h * hd), "wk": normal(d, kvh * hd),
            "wv": normal(d, kvh * hd), "wo": normal(h * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=const(0.0, h * hd), bk=const(0.0, kvh * hd), bv=const(0.0, kvh * hd))
    if cfg.qk_norm:
        attn.update(q_norm=const(1.0, hd), k_norm=const(1.0, hd))
    if cfg.mlp_act in ("swiglu", "geglu"):
        mlp = {"w_gate": normal(d, f), "w_up": normal(d, f), "w_down": normal(f, d, std=std_f)}
    else:
        mlp = {"w1": normal(d, f), "b1": const(0.0, f),
               "w2": normal(f, d, std=std_f), "b2": const(0.0, d)}
    return {"ln1": const(1.0, d), "attn": attn, "ln2": const(1.0, d), "mlp": mlp}


def init_lm_params(cfg, *, generator: torch.Generator, device=None) -> dict:
    """Random float32 parameters with the reference's leaves, scales and
    stacking, drawn from ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    v, d = cfg.vocab, cfg.d_model
    return {
        "embed": _normal((v, d), d ** -0.5, generator, device),
        "final_norm": torch.ones(d, device=device),
        "lm_head": _normal((d, v), d ** -0.5, generator, device),
        "layer0": None,
        "layers": _init_layers(cfg, generator, device),
    }


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's parameter tree (numpy leaves, ``layer0`` None, layers
    stacked) as the port's: the same tree of float32 tensors on ``device``."""
    device = resolve_device(device)
    if tree.get("layer0") is not None:
        raise NotImplementedError("a separate first layer (MoE dense0) is not ported yet "
                                  "(ROADMAP Queue 1 item 5)")
    return _tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device), tree)


def lm_params_to_numpy(params: dict) -> dict:
    """The port's parameters as the reference's tree of float32 numpy arrays."""
    return _tree_map(lambda t: t.detach().float().cpu().numpy(), params)


def serving_params(params: dict, cfg, device) -> dict:
    """The parameters a serving runner holds: every matmul weight and bias
    cast once to the activation dtype (what the reference's per-matmul
    ``.astype(x.dtype)`` computes, bitwise), the embedding table and the
    norm weights float32, all on ``device``. Leaves already in place are
    shared, not copied."""
    act = cfg.activation_dtype

    def walk(tree, name=None):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        dtype = torch.float32 if name in F32_LEAVES else act
        return tree.to(device=device, dtype=dtype)

    return walk(params)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s leaves, as views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _norm(x, w, cfg):
    return layers.rms_norm(x, w, eps=cfg.norm_eps)


def _mlp(h, p, cfg):
    if cfg.mlp_act in ("swiglu", "geglu"):
        return layers.glu_mlp(h, p["w_gate"], p["w_up"], p["w_down"], act=cfg.mlp_act)
    return layers.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"], act=cfg.mlp_act)


def _embed_in(params, tokens, cfg):
    x = layers.embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.embed_scale)
    return x.to(cfg.activation_dtype)


def norms_per_forward(cfg) -> int:
    """RMSNorm launches of one prefill or decode step: ln1 and ln2 per
    layer, the final norm, and q- and k-norm per layer with ``qk_norm``."""
    n = len(cfg.layer_kinds())
    return 2 * n + 1 + (2 * n if cfg.qk_norm else 0)


def _n_layers(cfg, params) -> int:
    """The number of stacked layers, after refusing what is not ported."""
    attn_lib.dense_only(cfg)
    if params.get("layer0") is not None:
        raise NotImplementedError("a separate first layer (MoE dense0) is not ported yet "
                                  "(ROADMAP Queue 1 item 5)")
    return len(cfg.layer_kinds())


# ---------------------------------------------------------------------------
# Serving: prefill + decode over stacked caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """The zeroed, stacked KV cache: {"layer0": None, "layers": {"k", "v"}}
    with k and v [L, batch, kvh, max_len, hd]."""
    device = resolve_device(device)
    attn_lib.dense_only(cfg)
    shape = (len(cfg.layer_kinds()), batch, cfg.kv_heads, max_len, cfg.head_dim_)
    return {"layer0": None, "layers": {
        name: torch.zeros(shape, dtype=dtype, device=device) for name in ("k", "v")}}


def _attn_prefill(p, h, cfg, positions, k_out, v_out):
    """Causal self-attention over the prompt through the flash kernel; the
    prompt's k/v are written into the first s positions of ``k_out`` /
    ``v_out`` [b, kvh, S, hd]."""
    b, s, _ = h.shape
    q, k, v = attn_lib._project_qkv(p, h, cfg, positions)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    # q, k, v go to the kernel as the strided [b, h, s, hd] views they are
    o = flash_ops.flash_attention(q.transpose(1, 2), kt, vt, causal=True)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim_)
    k_out[:, :, :s] = kt
    v_out[:, :, :s] = vt
    return o @ p["wo"].to(h.dtype)


def _prefill_layer(x, lp, cfg, positions, k_out, v_out):
    h = _norm(x, lp["ln1"], cfg)
    x = x + _attn_prefill(lp["attn"], h, cfg, positions, k_out, v_out)
    h = _norm(x, lp["ln2"], cfg)
    return x + _mlp(h, lp["mlp"], cfg)


def lm_prefill(params, tokens, cfg, max_len: Optional[int] = None, *, cache=None):
    """Process a prompt, returning (last-token logits [b, V] float32, cache
    at len(prompt), zero past it). The prompt's k/v are written into
    ``cache`` when one is given (a stacked cache of b rows, such as a
    serving runner's slot row, whose dtype rounds them once); otherwise
    into a new cache sized to ``max_len`` (defaults to the prompt length)
    in the activation dtype, as the reference's."""
    b, s = tokens.shape
    n = _n_layers(cfg, params)
    if cache is None:
        shape = (n, b, cfg.kv_heads, max_len or s, cfg.head_dim_)
        cache = {"layer0": None, "layers": {name: torch.empty(
            shape, dtype=cfg.activation_dtype, device=tokens.device) for name in ("k", "v")}}
    room = cache["layers"]["k"].shape[3]
    if s > room:
        raise ValueError(f"prompt of {s} tokens does not fit max_len={room}")
    for buf in cache["layers"].values():  # the reference's zero padding, all layers at once
        buf[:, :, :, s:] = 0
    x = _embed_in(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    for i in range(n):
        x = _prefill_layer(x, layer_params(params["layers"], i), cfg, positions,
                           cache["layers"]["k"][i], cache["layers"]["v"][i])
    h = _norm(x, params["final_norm"], cfg)
    return layers.logits_last(h[:, -1], params["lm_head"]), cache


def _decode_layer(x, lp, cache, index, cfg, n_keys):
    h = _norm(x, lp["ln1"], cfg)
    y, _ = attn_lib.attn_decode(lp["attn"], h, cache, index, cfg, n_keys=n_keys)
    x = x + y
    h = _norm(x, lp["ln2"], cfg)
    return x + _mlp(h, lp["mlp"], cfg)


def _decode_index(index, b: int, device) -> tuple:
    """(index tensor [b], max index + 1) from an int, a sequence or a tensor."""
    if isinstance(index, torch.Tensor):
        t = index.to(device=device, dtype=torch.long).reshape(-1).expand(b)
        return t, int(t.max()) + 1
    values = [int(index)] * b if np.ndim(index) == 0 else [int(i) for i in index]
    return torch.tensor(values, dtype=torch.long, device=device), max(values) + 1


def lm_decode_step(params, token, cache, index, cfg):
    """One decode step. token: [b, 1] int; index: the number of tokens
    already in each row's cache, an int for all rows or one per row (the
    reference's vmap over slots, as a batch). Returns (logits [b, V]
    float32, cache), the cache updated in place."""
    n = _n_layers(cfg, params)
    x = _embed_in(params, token, cfg)
    idx, n_keys = _decode_index(index, token.shape[0], x.device)
    for i in range(n):
        layer_cache = {"k": cache["layers"]["k"][i], "v": cache["layers"]["v"][i]}
        x = _decode_layer(x, layer_params(params["layers"], i), layer_cache, idx, cfg, n_keys)
    h = _norm(x, params["final_norm"], cfg)
    return layers.logits_last(h[:, 0], params["lm_head"]), cache
