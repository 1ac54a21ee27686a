"""Decoder-LM serving for the dense and MoE families: parameters, prefill, decode.

Port of the dense- and MoE-family part of ``repro.models.transformer``:
``init_lm_params``, ``_init_layer``, ``_norm``, the prefill layer,
``lm_prefill``, ``_attn_prefill``, ``_mla_prefill``, ``init_cache``,
``_decode_layer`` and ``lm_decode_step``. Parameters keep the reference's
tree and leaf names, with the layers stacked on a leading layer dim::

    {"embed": [V, d], "final_norm": [d], "lm_head": [d, V], "layer0": None,
     "layers": {"ln1": [L, d], "attn": {"wq": [L, d, h*hd], ...},
                "ln2": [L, d], "mlp": {...}}}

An MoE config whose first layer is dense (``moe.first_dense_ff``) keeps
that layer unstacked under ``layer0`` and stacks the ``moe`` layers, which
hold {"router", "w_gate": [L, E, d, f], ..., "shared": {...}} under
``moe`` in place of ``mlp``; under MLA ``attn`` holds {"wq", "w_dkv",
"kv_norm", "k_up", "v_up", "wo"}.
The reference's ``lax.scan`` over the stack is a Python loop over its
layer views. ``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry a
parameter tree across the two packages. Caches are laid out the same way,
{"layer0": None or one layer's, "layers": {"k", "v"}: [L, b, kvh, S, hd]}
(under MLA {"ckv": [L, b, S, kv_lora], "kr": [L, b, S, dh_rope]}), and
``lm_decode_step`` updates them in place.

Every RMSNorm goes through the fused RMSNorm kernel and every prefill
attention through the flash-attention kernel (their plain versions for CPU
tensors): ``norms_per_forward(cfg)`` norms per prefill or decode step
(2 L + 1, plus 2 L with qk-norm and L with MLA's latent norm) and L flash
launches per prefill.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib

# leaves that stay float32 when the serving runner casts the rest to the
# activation dtype (the reference casts every other weight at its matmul).
# MLA's k_up and v_up: the reference casts them at the prefill's matmuls
# but runs the absorbed decode with them in float32, so the runner keeps
# them float32 and the prefill casts them at each use.
F32_LEAVES = ("embed", "final_norm", "ln1", "ln2", "q_norm", "k_norm", "kv_norm", "k_up", "v_up")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _normal(shape, std, generator, device):
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def _init_attn(cfg, normal, const) -> dict:
    d, hd, h, kvh = cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.kv_heads
    std = d ** -0.5
    attn = {"wq": normal("wq", (d, h * hd), std), "wk": normal("wk", (d, kvh * hd), std),
            "wv": normal("wv", (d, kvh * hd), std), "wo": normal("wo", (h * hd, d), std)}
    if cfg.qkv_bias:
        attn.update(bq=const("bq", (h * hd,), 0.0), bk=const("bk", (kvh * hd,), 0.0),
                    bv=const("bv", (kvh * hd,), 0.0))
    if cfg.qk_norm:
        attn.update(q_norm=const("q_norm", (hd,), 1.0), k_norm=const("k_norm", (hd,), 1.0))
    return attn


def _init_mlp(d, f, act, normal, const) -> dict:
    std_d, std_f = d ** -0.5, f ** -0.5
    if act in ("swiglu", "geglu"):
        return {"w_gate": normal("w_gate", (d, f), std_d), "w_up": normal("w_up", (d, f), std_d),
                "w_down": normal("w_down", (f, d), std_f)}
    return {"w1": normal("w1", (d, f), std_d), "b1": const("b1", (f,), 0.0),
            "w2": normal("w2", (f, d), std_f), "b2": const("b2", (d,), 0.0)}


def _init_layer(cfg, kind: str, normal, const) -> dict:
    """One layer's leaves for ``kind`` (dense, dense0 or moe); ``normal`` and
    ``const`` make each leaf (stacked or not, finished as they choose)."""
    d = cfg.d_model
    p = {"ln1": const("ln1", (d,), 1.0)}
    if cfg.mla is not None:
        p["attn"] = attn_lib.init_mla_params(cfg, normal, lambda name, shape: const(name, shape, 1.0))
    else:
        p["attn"] = _init_attn(cfg, normal, const)
    p["ln2"] = const("ln2", (d,), 1.0)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe_params(d, cfg.moe, normal)
    else:
        f = cfg.moe.first_dense_ff if kind == "dense0" else cfg.d_ff
        p["mlp"] = _init_mlp(d, f, cfg.mlp_act, normal, const)
    return p


def _serving_dtype(name: str, cfg) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES else cfg.activation_dtype


def init_lm_params(cfg, *, generator: torch.Generator, device=None, serving: bool = False) -> dict:
    """Random float32 parameters with the reference's leaves, scales and
    stacking, drawn from ``generator`` (which must live on ``device``) one
    leaf at a time. With ``serving`` each leaf is cast as soon as it is
    drawn to what ``serving_params`` would hold (bitwise the same), so the
    float32 masters never coexist: the peak is the cast tree plus one
    float32 leaf."""
    device = resolve_device(device)
    attn_lib.dense_only(cfg)
    v, d = cfg.vocab, cfg.d_model
    finish = (lambda name, t: t.to(_serving_dtype(name, cfg))) if serving else (lambda name, t: t)

    def makers(lead):
        def normal(name, shape, std):
            return finish(name, _normal(lead + tuple(shape), std, generator, device))

        def const(name, shape, value):
            return finish(name, torch.full(lead + tuple(shape), value, dtype=torch.float32,
                                           device=device))
        return normal, const

    params = {
        "embed": finish("embed", _normal((v, d), d ** -0.5, generator, device)),
        "final_norm": finish("final_norm", torch.ones(d, device=device)),
        "lm_head": finish("lm_head", _normal((d, v), d ** -0.5, generator, device)),
    }
    kinds = cfg.layer_kinds()
    first = kinds[0] == "dense0"
    params["layer0"] = _init_layer(cfg, "dense0", *makers(())) if first else None
    params["layers"] = _init_layer(cfg, kinds[-1], *makers((len(kinds) - first,)))
    return params


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's parameter tree (numpy leaves, ``layer0`` None or the
    first dense layer's, layers stacked) as the port's: the same tree of
    float32 tensors on ``device``."""
    device = resolve_device(device)
    return _tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device), tree)


def lm_params_to_numpy(params: dict) -> dict:
    """The port's parameters as the reference's tree of float32 numpy arrays."""
    return _tree_map(lambda t: t.detach().float().cpu().numpy(), params)


def serving_params(params: dict, cfg, device) -> dict:
    """The parameters a serving runner holds: every matmul weight and bias
    cast once to the activation dtype (what the reference's per-matmul
    ``.astype(x.dtype)`` computes, bitwise), the embedding table, the norm
    weights and MLA's up-projections float32, all on ``device``. Leaves
    already in place are shared, not copied."""
    def walk(tree, name=None):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree.to(device=device, dtype=_serving_dtype(name, cfg))

    return walk(params)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s leaves, as views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _norm(x, w, cfg):
    return layers.rms_norm(x, w, eps=cfg.norm_eps)


def _ffn(h, lp, kind, cfg, dropless=False):
    """The layer's feed-forward half: routed + shared experts, or an MLP."""
    if kind == "moe":
        return moe_lib.moe_apply(lp["moe"], h, cfg.moe, dropless=dropless)
    p = lp["mlp"]
    if cfg.mlp_act in ("swiglu", "geglu"):
        return layers.glu_mlp(h, p["w_gate"], p["w_up"], p["w_down"], act=cfg.mlp_act)
    return layers.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"], act=cfg.mlp_act)


def _embed_in(params, tokens, cfg):
    x = layers.embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.embed_scale)
    return x.to(cfg.activation_dtype)


def norms_per_forward(cfg) -> int:
    """RMSNorm launches of one prefill or decode step: ln1 and ln2 per
    layer, the final norm, q- and k-norm per layer with ``qk_norm``, and
    the latent's kv_norm per layer under MLA."""
    n = len(cfg.layer_kinds())
    return 2 * n + 1 + (2 * n if cfg.qk_norm else 0) + (n if cfg.mla is not None else 0)


def _layers(cfg, params, cache):
    """(layer params, layer cache, kind) of every layer in order; the
    stacked ones as views."""
    kinds = cfg.layer_kinds()
    first = kinds[0] == "dense0"
    if first != (params.get("layer0") is not None):
        raise ValueError(f"{cfg.name}: layer0 params {'missing' if first else 'given'} for "
                         f"layer kinds {kinds[:2]}...")
    out = [(params["layer0"], cache["layer0"], kinds[0])] if first else []
    stacked = cache["layers"]
    for i in range(len(kinds) - first):
        out.append((layer_params(params["layers"], i), {n: c[i] for n, c in stacked.items()},
                    kinds[first + i]))
    return out


# ---------------------------------------------------------------------------
# Serving: prefill + decode over stacked caches
# ---------------------------------------------------------------------------

def _new_cache(cfg, batch: int, max_len: int, dtype, device, alloc) -> dict:
    kinds = cfg.layer_kinds()
    first = kinds[0] == "dense0"

    def make(lead):
        return {name: alloc(lead + shape, dtype=dtype, device=device)
                for name, shape in attn_lib.cache_shapes(cfg, batch, max_len).items()}

    return {"layer0": make(()) if first else None, "layers": make((len(kinds) - first,))}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """The zeroed cache: {"layer0": one layer's or None, "layers": stacked},
    k and v [L, batch, kvh, max_len, hd], or under MLA ckv [L, batch,
    max_len, kv_lora] and kr [L, batch, max_len, dh_rope]."""
    device = resolve_device(device)
    attn_lib.dense_only(cfg)
    return _new_cache(cfg, batch, max_len, dtype, device, torch.zeros)


def cache_rows(cache: dict, start: int, stop: int) -> dict:
    """Rows ``start:stop`` of every leaf of ``cache``, as views (a serving
    runner's slot rows; the batch dim follows the stacked layer dim)."""
    layer0 = cache["layer0"]
    return {"layer0": None if layer0 is None else {n: c[start:stop] for n, c in layer0.items()},
            "layers": {n: c[:, start:stop] for n, c in cache["layers"].items()}}


def _cache_leaves(cache: dict) -> list:
    return [c for part in (cache["layer0"], cache["layers"]) if part for c in part.values()]


def _attn_prefill(p, h, cfg, positions, lc):
    """Causal self-attention over the prompt through the flash kernel; the
    prompt's k/v are written into the first s positions of the layer's
    cache ``lc`` {"k", "v"}: [b, kvh, S, hd]."""
    b, s, _ = h.shape
    q, k, v = attn_lib._project_qkv(p, h, cfg, positions)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    # q, k, v go to the kernel as the strided [b, h, s, hd] views they are
    o = flash_ops.flash_attention(q.transpose(1, 2), kt, vt, causal=True)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim_)
    lc["k"][:, :, :s] = kt
    lc["v"][:, :, :s] = vt
    return o @ p["wo"].to(h.dtype)


def _mla_prefill(p, h, cfg, positions, lc):
    """MLA over the prompt; its latent and RoPE key are written into the
    first s positions of ``lc`` {"ckv", "kr"}: [b, S, ...]."""
    s = h.shape[1]
    out, ckv, k_rope = attn_lib.mla_forward(p, h, cfg, positions=positions, return_latents=True)
    lc["ckv"][:, :s] = ckv
    lc["kr"][:, :s] = k_rope
    return out


def _prefill_layer(x, lp, kind, cfg, positions, lc):
    h = _norm(x, lp["ln1"], cfg)
    attend = _mla_prefill if cfg.mla is not None else _attn_prefill
    x = x + attend(lp["attn"], h, cfg, positions, lc)
    h = _norm(x, lp["ln2"], cfg)
    return x + _ffn(h, lp, kind, cfg)


def lm_prefill(params, tokens, cfg, max_len: Optional[int] = None, *, cache=None):
    """Process a prompt, returning (last-token logits [b, V] float32, cache
    at len(prompt), zero past it). The prompt's k/v (or MLA latents) are
    written into ``cache`` when one is given (a cache of b rows, such as a
    serving runner's slot row, whose dtype rounds them once); otherwise
    into a new cache sized to ``max_len`` (defaults to the prompt length),
    as the reference's: in the activation dtype, bf16 under MLA. The MoE
    layers route the whole prompt at once, so its capacity (and what it
    drops) is the reference's for this prompt."""
    attn_lib.dense_only(cfg)
    b, s = tokens.shape
    if cache is None:
        dtype = torch.bfloat16 if cfg.mla is not None else cfg.activation_dtype
        cache = _new_cache(cfg, b, max_len or s, dtype, tokens.device, torch.empty)
    leaves = _cache_leaves(cache)
    room = leaves[0].shape[-2]
    if s > room:
        raise ValueError(f"prompt of {s} tokens does not fit max_len={room}")
    for buf in leaves:  # the reference's zero padding, all layers at once
        buf[..., s:, :] = 0
    x = _embed_in(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    for lp, lc, kind in _layers(cfg, params, cache):
        x = _prefill_layer(x, lp, kind, cfg, positions, lc)
    h = _norm(x, params["final_norm"], cfg)
    return layers.logits_last(h[:, -1], params["lm_head"]), cache


def _decode_layer(x, lp, kind, lc, index, cfg, n_keys):
    h = _norm(x, lp["ln1"], cfg)
    decode = attn_lib.mla_decode if cfg.mla is not None else attn_lib.attn_decode
    y, _ = decode(lp["attn"], h, lc, index, cfg, n_keys=n_keys)
    x = x + y
    h = _norm(x, lp["ln2"], cfg)
    return x + _ffn(h, lp, kind, cfg, dropless=True)


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
    float32, cache), the cache updated in place. The MoE layers route the
    b tokens together with room for all b on every expert, so they drop
    none, as the reference's one-token steps drop none, for any b."""
    attn_lib.dense_only(cfg)
    x = _embed_in(params, token, cfg)
    idx, n_keys = _decode_index(index, token.shape[0], x.device)
    for lp, lc, kind in _layers(cfg, params, cache):
        x = _decode_layer(x, lp, kind, lc, idx, cfg, n_keys)
    h = _norm(x, params["final_norm"], cfg)
    return layers.logits_last(h[:, 0], params["lm_head"]), cache
