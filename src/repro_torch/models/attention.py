"""GQA/MQA/MHA attention with a KV cache: projections and decode.

Port of the dense part of ``repro.models.attention``: ``_project_qkv``
(with ``qkv_bias``, ``qk_norm`` and partial RoPE), ``init_kv_cache``,
``attn_decode`` and ``decode_attention`` (``attention.py:55-74``,
``:184-259``, ``:333-345``). Split and quantised caches, sliding windows
and MLA are not ported (ROADMAP Queue 1 item 5).

Layouts as in the reference: residual stream [b, s, d]; heads [b, h, s,
hd]; the cache {"k": [b, kvh, S, hd], "v": ...}.

Decode is batched over slots with a per-slot index vector, where the
reference vmaps a batch-1 step over the slots: each row gets its own RoPE
position, its own cache row to write and its own valid prefix. The cache
is updated in place (the reference returns a new one); ``attn_decode``
returns the same dict.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import NOT_PORTED
from repro_torch.models import layers

NEG_INF = -1e30


def _project_qkv(p, x, cfg, positions):
    """x: [b, s, d] -> q [b, s, h, hd], k and v [b, s, kvh, hd]."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.kv_heads, hd)
    v = v.reshape(b, s, cfg.kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"])
        k = layers.rms_norm(k, p["k_norm"])
    if cfg.rope_fraction > 0:
        q = layers.apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        k = layers.apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    return q, k, v


def dense_only(cfg):
    """Refuse the variants that are not ported: sliding windows, LayerNorm."""
    if cfg.window is not None:
        raise NotImplementedError(f"sliding-window caches: {NOT_PORTED}")
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r}: {NOT_PORTED}")


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """Plain cache: one zeroed [batch, kvh, max_len, hd] buffer per k/v."""
    dense_only(cfg)
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x, cache, index, cfg, n_keys=None):
    """One decode step for every row: write its k/v at its own ``index``
    and attend over its valid prefix.

    x: [b, 1, d]; cache {"k", "v"}: [b, kvh, S, hd], updated in place;
    index: int tensor [b], the number of tokens already in each row's
    cache; ``n_keys`` = max(index) + 1 when the caller knows it (else it is
    read from the device). Returns (out [b, 1, d], cache)."""
    dense_only(cfg)
    b = x.shape[0]
    hd = cfg.head_dim_
    q, k, v = _project_qkv(p, x, cfg, index[:, None])
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, :, index] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, :, index] = v[:, 0].to(cache["v"].dtype)
    # keys past every row's index are masked; attend over the longest prefix
    n = int(index.max()) + 1 if n_keys is None else n_keys
    valid = torch.arange(n, device=x.device)[None, :] <= index[:, None]
    o = decode_attention(q.transpose(1, 2), cache["k"][:, :, :n], cache["v"][:, :, :n], valid)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * hd)
    return o @ p["wo"].to(x.dtype), cache


def decode_attention(q, k, v, valid):
    """q: [b, h, 1, hd]; k/v: [b, kvh, s, hd]; valid: [b or 1, s] bool.

    As the reference: q cast to the cache dtype, logits accumulated in f32
    (here by upcasting both operands: a bf16 x bf16 product is exact in
    f32), softmax in f32, weights cast to the cache dtype before P.V,
    accumulated in f32, result in q's dtype."""
    b, h, _, hd = q.shape
    kvh = k.shape[1]
    group = h // kvh
    qg = q.reshape(b, kvh, group, hd).to(k.dtype)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(), k.float()) * (hd ** -0.5)
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(v.dtype).float(), v.float())
    return o.reshape(b, h, 1, hd).to(q.dtype)
