"""GQA/MQA/MHA (with sliding windows) and MLA attention with a KV cache.

Port of ``repro.models.attention``: ``_project_qkv`` (with ``qkv_bias``,
``qk_norm`` and partial RoPE), ``attn_forward`` (full-sequence attention,
causal or not; under a mesh policy tensor-parallel over heads with the
reference's head padding, ``_pad_heads``), ``_windowed_attention``,
``init_kv_cache`` (with the split and int8 layouts), ``quantize_kv``,
``attn_decode`` (with ``_ring_decode``), ``_attn_decode_split``, ``flush_tail`` and
``decode_attention`` (``attention.py:55-74``, ``:77-345``), and
DeepSeek-V2's multi-head latent attention: ``init_mla_params``,
``_mla_qkr``, ``mla_forward`` (under a mesh policy tensor-parallel over
heads, ``_mla_tp``), ``init_mla_cache`` (with the split layout) and
``mla_decode`` with its absorbed split decode (``_mla_decode_split``;
``:354-479``).

Tensor parallelism (``_attn_tp``): wq/wk/wv are column-parallel and wo
row-parallel over the model group (``param_specs``). The heads are
zero-padded to a multiple of P (``padded_heads``), rank m takes padded
heads m hp/P .. and the padded heads' outputs are sliced away, as the
reference's ``_pad_heads`` makes GSPMD do. Where a rank's heads are not
its columns of a weight (P does not divide the heads; the kv heads of a
GQA config that P does not divide, chatglm3-6b's 2 on 4 ranks), the rank
all-gathers that weight and takes its heads' columns (its rows of wo):
the gather's backward reduce-scatters, so two ranks reading one kv head
both send it their gradient. A GQA config keeps its groups where the
rank's q heads hold whole runs of a kv head or lie inside one
(``core.ulysses.kv_heads_for``), else each q head gets its kv head
(``tp_heads``). ``_attn_tp`` also takes the k/v input apart from the q
input (``kv_x``: the encoder-decoder's cross-attention, whose k/v come
from the encoder's output), and ``pick_heads`` cuts a block's shards to
the rank's heads once, for a serving loop that should gather no weight
a step.

Layouts as in the reference: residual stream [b, s, d]; heads [b, h, s,
hd]; the cache {"k": [b, kvh, S, hd], "v": ...}; the MLA cache {"ckv":
[b, S, kv_lora], "kr": [b, S, dh_rope]}, the compressed latent and the
shared RoPE key, bf16 whatever the activation dtype. Under a sliding
window (RecurrentGemma's local attention) the cache is a ring of S =
min(max_len, window) positions, position t at slot t % S.

Decode is batched over slots with a per-slot index vector, where the
reference vmaps a batch-1 step over the slots: each row gets its own RoPE
position, its own cache row (and ring slot) to write and its own valid
keys. The cache is updated in place (the reference returns a new one);
``attn_decode`` returns the same dict.

Split caches (every attention cache without a window under a mesh
policy): a read-only prefix of S positions, int8 under ``kv_quant``, and
a ``TAIL_LEN`` tail that each decode step writes and ``flush_tail``
empties into the prefix. Each row attends over its valid prefix length
and its tail entries, where the reference attends over the whole prefix
(see ``_attn_decode_split``). Over a model group the prefix is sharded by
kv heads where P divides them, else by sequence (MLA's latent prefix
always, ``prefix_by_sequence``), each rank a contiguous
chunk of S/P positions of every kv head, the softmax combined over the
group: the paper's domain decomposition applied to decode. The tail is
whole on every rank of a sequence-sharded layout (the reference's spec);
in a head-sharded layout it holds the rank's kv heads, the only ones the
rank reads (the reference's spec replicates it, which its GSPMD fills by
an all-gather of every step's k and v). A sliding window's ring has no
tail: over a model group it is sharded the same way, by kv heads or by
sequence, each rank holding a contiguous chunk of the ring's slots, and
a decode step combines the chunks as the split decode combines a
prefix's (``_chunk_sums``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.collectives import (
    all_gather, all_reduce_max, all_reduce_sum, copy_to, gather_from, reduce_from, scatter_to,
)
from repro_torch.core.ulysses import kv_heads_for
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.models import layers
from repro_torch.models.policy import LOCAL

NEG_INF = -1e30
TAIL_LEN = 64  # a split cache's tail (flushed into the prefix every TAIL_LEN steps)


def _project_qkv(p, x, cfg, positions):
    """x: [b, s, d] -> q [b, s, h, hd], k and v [b, s, kvh, hd]."""
    q, k, v = _projections(p, x, cfg, "qkv")
    return (_heads(p, q, cfg, positions, "q_norm"), _heads(p, k, cfg, positions, "k_norm"),
            _heads(p, v, cfg, positions))


def _projections(p, x, cfg, which: str, group=None):
    """x @ w (+ bias) for each of ``which``'s projections ("q", "k", "v"),
    each all-gathered over ``group`` when one is given (the rank's columns
    of it -> all of them)."""
    out = []
    for c in which:
        y = x @ p["w" + c].to(x.dtype)
        if cfg.qkv_bias:
            y = y + p["b" + c].to(x.dtype)
        out.append(y if group is None else gather_from(y, -1, group))
    return out


def _heads(p, y, cfg, positions, norm=None):
    """A projection [b, s, n * hd] as heads [b, s, n, hd]; q's and k's
    (``norm``: their qk-norm weight's name) normed and rotated."""
    b, s, _ = y.shape
    y = y.reshape(b, s, -1, cfg.head_dim_)
    if norm is None:
        return y
    if cfg.qk_norm:
        y = layers.rms_norm(y, p[norm])
    if cfg.rope_fraction > 0:
        y = layers.apply_rope(y, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    return y


def attend(q, k, v, cfg, *, causal: bool = True):
    """q: [b, h, s, hd]; k/v: [b, kvh, s, hd] -> [b, h, s, hd]: through
    the flash kernel, or for a prompt past a sliding window through
    ``_windowed_attention`` (which the reference takes there, causal)."""
    if cfg.window is not None and q.shape[2] > cfg.window:
        return _windowed_attention(q, k, v, cfg.window)
    return flash_ops.flash_attention(q, k, v, causal=causal)


def attn_forward(p, x, cfg, policy=LOCAL, *, causal: bool = True, seq_sharded: bool = False):
    """Full-sequence attention (training, or an encoder) at positions
    0..s-1: x [b, s, d] -> [b, s, d], one flash launch within a window.
    q, k and v go to the kernel as the strided [b, h, s, hd] views they
    are. Under a policy whose model group has more than one rank, ``p``
    holds this rank's shards and x the residual stream as the block holds
    it (this rank's slice of the sequence with ``seq_sharded``):
    ``_attn_tp``."""
    if policy.model_size() > 1:
        return _attn_tp(p, x, cfg, policy, causal, seq_sharded)
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, torch.arange(s, device=x.device))
    o = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), cfg, causal=causal)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim_)
    return o @ p["wo"].to(x.dtype)


def padded_heads(n_heads: int, p_size: int) -> int:
    """The head count zero-padded to a multiple of the model group's size."""
    return -(-n_heads // p_size) * p_size


class TPHeads(NamedTuple):
    """This rank's heads over the model group: ``n_loc`` padded q heads a
    rank, the ``n_real`` of them that are real (``q_heads``, an index
    tensor), the kv heads they attend with (``kv_heads``; with ``per_q``
    one a q head, padded like them), and whether the rank's column shards
    of the q and kv projections are those heads' columns (``q_aligned``,
    ``kv_aligned``)."""
    n_loc: int
    n_real: int
    q_heads: torch.Tensor
    kv_heads: torch.Tensor
    per_q: bool
    q_aligned: bool
    kv_aligned: bool

    @property
    def n_kv(self) -> int:
        """The kv heads the rank attends with, padding included."""
        return self.n_loc if self.per_q else self.kv_heads.numel()


def tp_heads(cfg, policy, device=None) -> TPHeads:
    """This rank's ``TPHeads`` (see the module's docstring): padded heads
    m hp/P .. of the model group's rank m; an MHA config (or a GQA rank
    with padded heads) takes one kv head a q head, a GQA one its q heads'
    runs (``core.ulysses.kv_heads_for``)."""
    size, rank = policy.model_size(), policy.model_rank()
    h, kvh = cfg.n_heads, cfg.kv_heads
    n_loc = padded_heads(h, size) // size
    first = rank * n_loc
    n_real = max(0, min(n_loc, h - first))
    q_heads = torch.arange(first, first + n_real, device=device)
    per_q = kvh == h or n_real < n_loc
    if per_q:
        kv_heads = q_heads if kvh == h else q_heads // (h // kvh)
    else:
        kv_heads = kv_heads_for(first, n_loc, h, kvh, device)
    q_aligned = h % size == 0
    return TPHeads(n_loc, n_real, q_heads, kv_heads, per_q, q_aligned,
                   q_aligned and kvh % size == 0)


def _columns(w, heads, hd: int, aligned: bool, group, dim: int = -1):
    """The columns (rows with ``dim=0``) of heads ``heads`` (a 1-D index
    tensor) of a weight the group shards along ``dim``: this rank's shard
    itself when ``aligned`` or when it holds exactly those heads already
    (``pick_heads``), else picked from the all-gathered weight."""
    if aligned or w.shape[dim] == heads.numel() * hd:
        return w
    full = all_gather(w, dim, group)
    cols = (heads[:, None] * hd + torch.arange(hd, device=w.device)).reshape(-1)
    return full.index_select(dim, cols)


def pick_heads(p, cfg, policy) -> dict:
    """An attention block's shards (one layer's, or stacked on a leading
    layer dim) cut to this rank's heads once (one all-gather a leaf where
    the shards are not the heads' columns): wq/bq the q heads' columns,
    wk/bk/wv/bv the kv heads', wo the q heads' rows.
    The tensor-parallel paths take such a block as is (``_columns``), so a
    serving loop gathers no weight per step."""
    hs, hd, group = tp_heads(cfg, policy, p["wq"].device), cfg.head_dim_, policy.model_group
    out = dict(p)
    for name in ("wq", "bq", "wk", "bk", "wv", "bv", "wo"):
        if name in p:
            heads, aligned = ((hs.q_heads, hs.q_aligned) if name[1] in "qo"
                              else (hs.kv_heads, hs.kv_aligned))
            out[name] = _columns(p[name], heads, hd, aligned, group, dim=-2 if name == "wo" else -1)
    return out


def _project(x, w, b, heads, hd, aligned, group):
    """x @ W[:, heads] (+ bias) for a column-parallel W -> [b, s, n, hd]."""
    y = x @ _columns(w, heads, hd, aligned, group).to(x.dtype)
    if b is not None:
        y = y + _columns(b, heads, hd, aligned, group).to(x.dtype)
    return y.reshape(x.shape[0], x.shape[1], heads.numel(), hd)


def _tp_qkv(p, x, kv_x, cfg, policy, hs: TPHeads, positions, kv_positions):
    """q [b, s, n_loc, hd] of this rank's heads from x, and k, v [b, s_kv,
    n_kv, hd] of its kv heads from ``kv_x`` (x itself for self-attention),
    each padded with zero heads to the rank's count; q/k-norm and RoPE at
    the positions given."""
    group, hd = policy.model_group, cfg.head_dim_
    bias = cfg.qkv_bias
    q = _project(x, p["wq"], p["bq"] if bias else None, hs.q_heads, hd, hs.q_aligned, group)
    k = _project(kv_x, p["wk"], p["bk"] if bias else None, hs.kv_heads, hd, hs.kv_aligned, group)
    v = _project(kv_x, p["wv"], p["bv"] if bias else None, hs.kv_heads, hd, hs.kv_aligned, group)
    if cfg.qk_norm:  # whole weights on this rank's heads: their gradient is a part
        q = layers.rms_norm(q, copy_to(p["q_norm"], group))
        k = layers.rms_norm(k, copy_to(p["k_norm"], group))
    if cfg.rope_fraction > 0:
        q = layers.apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        k = layers.apply_rope(k, kv_positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    pad = hs.n_loc - hs.n_real
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    return q, k, v


def tp_heads_out(o, p, hs: TPHeads, cfg, policy, dtype, seq_sharded: bool = False):
    """The attention output of this rank's padded heads o [b, n_loc, s,
    hd] through its real heads' rows of ``wo``, the partial products summed
    over the group (``layers.tp_out``): [b, s, d]."""
    b, _, s, hd = o.shape
    o = o[:, :hs.n_real].transpose(1, 2).reshape(b, s, hs.n_real * hd)
    wo = _columns(p["wo"], hs.q_heads, hd, hs.q_aligned, policy.model_group, dim=0)
    return layers.tp_out(o @ wo.to(dtype), policy.model_group, seq_sharded)


def tp_q(p, x, cfg, policy, hs: TPHeads):
    """q [b, n_loc, s, hd] of this rank's padded heads from x (no
    position rotation: the encoder-decoder's cross-attention)."""
    q = _project(x, p["wq"], p["bq"] if cfg.qkv_bias else None, hs.q_heads, cfg.head_dim_,
                 hs.q_aligned, policy.model_group)
    return F.pad(q, (0, 0, 0, hs.n_loc - hs.n_real)).transpose(1, 2)


def _attn_tp(p, x, cfg, policy, causal: bool, seq_sharded: bool, with_kv: bool = False,
             kv_x=None, attend_fn=None):
    """``attn_forward`` over the model group: see the module's docstring.
    ``kv_x`` (cross-attention): the k/v input [b, s_kv, d], whole on every
    rank and already entered into the group (``copy_to``, or the
    all-gather of a sequence-sharded one), apart from the q input x.
    ``attend_fn(q, k, v, causal)`` replaces ``attend`` (a plain version).
    With ``with_kv`` also returns the whole sequence's x as the rank took
    it in, and the k and v [b, s, n_kv, hd] of the kv heads it attended
    with, padding included."""
    xin = layers.tp_in(x, policy.model_group, seq_sharded)
    kin = xin if kv_x is None else kv_x
    hs = tp_heads(cfg, policy, x.device)
    q, k, v = _tp_qkv(p, xin, kin, cfg, policy, hs, torch.arange(xin.shape[1], device=x.device),
                      torch.arange(kin.shape[1], device=x.device))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    o = (attend(qt, kt, vt, cfg, causal=causal) if attend_fn is None
         else attend_fn(qt, kt, vt, causal))
    out = tp_heads_out(o, p, hs, cfg, policy, x.dtype, seq_sharded)
    return (out, xin, k, v) if with_kv else out


def cache_leaves(cfg, batch: int, max_len: int, dtype, *, split: bool = False,
                 quant: bool = False) -> dict:
    """{name: (shape, dtype)} of one layer's cache, the reference's leaves
    (``init_kv_cache``, ``init_mla_cache``): the prefix k and v in
    ``dtype``, int8 with ``quant`` on a split cache without a window, and
    then k_scale and v_scale [b, kvh, S] bf16; the split cache's tail tk
    and tv [b, kvh, TAIL_LEN, hd] in ``dtype``. MLA's latent ckv and RoPE
    key kr [b, S, ...], split with a tail tckv and tkr [b, TAIL_LEN, ...],
    in ``dtype`` whatever ``quant`` (the reference quantizes no latent)."""
    if cfg.mla is not None:
        m = cfg.mla
        out = {"ckv": ((batch, max_len, m.kv_lora), dtype),
               "kr": ((batch, max_len, m.dh_rope), dtype)}
        if split:
            out.update(tckv=((batch, TAIL_LEN, m.kv_lora), dtype),
                       tkr=((batch, TAIL_LEN, m.dh_rope), dtype))
        return out
    length = max_len if cfg.window is None else min(max_len, cfg.window)
    split = split and cfg.window is None
    kv_dtype = torch.int8 if quant and split else dtype
    shape = (batch, cfg.kv_heads, length, cfg.head_dim_)
    out = {"k": (shape, kv_dtype), "v": (shape, kv_dtype)}
    if kv_dtype == torch.int8:
        out.update(k_scale=(shape[:3], torch.bfloat16), v_scale=(shape[:3], torch.bfloat16))
    if split:
        tail = (batch, cfg.kv_heads, TAIL_LEN, cfg.head_dim_)
        out.update(tk=(tail, dtype), tv=(tail, dtype))
    return out


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None, *,
                  split: bool = False, quant: bool = False) -> dict:
    """Plain cache: one zeroed [batch, kvh, S, hd] buffer per k/v (S =
    max_len, or the ring's min(max_len, window)).

    ``split`` (no window): the reference's prefix/tail layout. The prefix
    is read-only inside a decode step, so that it can be sharded over the
    model group; each step's k/v go to a ``TAIL_LEN`` tail, which
    ``flush_tail`` writes into the prefix. ``quant`` (with ``split``): the
    prefix is int8 with per-token, per-head max-abs scales (bf16), which
    fold into the logits and the softmax weights."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_leaves(cfg, batch, max_len, dtype, split=split,
                                                   quant=quant).items()}


def quantize_kv(x):
    """x: [..., s, hd] -> (int8 values, bf16 per-token scales [..., s]):
    the reference's max-abs rounding, value for value."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _windowed_attention(q, k, v, window: int):
    """Sliding-window causal attention (RecurrentGemma's local layers),
    which the reference takes for prompts longer than the window, outside
    any kernel. q: [b, h, s, hd]; k/v: [b, kvh, s, hd].

    Queries run in window-sized blocks, each against its own and the
    previous key block (the positions within the window), never the full
    s x s matrix. As the reference: logits in q's dtype, then float32 and
    scaled, masked with ``where`` to -1e30, the softmax in float32 cast to
    q's dtype before P.V."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    pad = (-s) % window  # end-pad: padded keys lie in every real query's future
    q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    nb = (s + pad) // window
    qb, kb, vb = (t.reshape(b, h, nb, window, hd) for t in (q, k, v))
    # the previous block of keys and values (zeros for block 0)
    kcat = torch.cat([F.pad(kb, (0, 0, 0, 0, 1, 0))[:, :, :nb], kb], dim=3)  # [b, h, nb, 2w, hd]
    vcat = torch.cat([F.pad(vb, (0, 0, 0, 0, 1, 0))[:, :, :nb], vb], dim=3)
    logits = torch.einsum("bhnqd,bhnkd->bhnqk", qb, kcat).float() * hd ** -0.5
    qpos = torch.arange(window, device=q.device)[:, None] + window  # position in the 2w slab
    kpos = torch.arange(2 * window, device=q.device)[None, :]
    valid = (kpos <= qpos) & (kpos > qpos - window)
    mask = valid.expand(nb, window, 2 * window).clone()
    mask[0] &= kpos >= window  # block 0 has no previous keys
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhnqk,bhnkd->bhnqd", w, vcat)
    return o.reshape(b, h, s + pad, hd)[:, :, :s]


def attn_decode(p, x, cache, index, cfg, n_keys=None, *, policy=LOCAL, prefix_len=None):
    """One decode step for every row: write its k/v at its own ``index``
    (under a window at its ring slot index % S) and attend over its valid
    keys: the prefix up to ``index``, or under a window the ring's slots up
    to that slot, every slot once the row has wrapped (index >= S).

    x: [b, 1, d]; cache {"k", "v"}: [b, kvh, S, hd], updated in place;
    index: int tensor [b], the number of tokens already in each row's
    cache; ``n_keys`` = max(index) + 1 when the caller knows it (else it is
    read from the device). Returns (out [b, 1, d], cache).

    A split cache (a "tk" leaf) goes to ``_attn_decode_split``, with each
    row's valid prefix length ``prefix_len``; under a policy whose model
    group has more than one rank every LM attention cache without a window
    is split. A window's ring over such a group is held by kv heads or by
    sequence (``_ring_decode``); a plain cache over such a group (a ring
    by kv heads, the encoder-decoder's self cache) holds this rank's kv
    heads (``tp_heads``, padding included), which its q heads attend
    over, ``wo`` row-parallel (``tp_heads_out``)."""
    if "tk" in cache:
        return _attn_decode_split(p, x, cache, index, cfg, policy, prefix_len)
    if cfg.window is not None and prefix_by_sequence(cfg, policy):
        return _ring_decode(p, x, cache, index, cfg, policy, n_keys)
    b = x.shape[0]
    hd = cfg.head_dim_
    s_max = cache["k"].shape[2]
    tp = policy.model_size() > 1
    if tp:
        hs = tp_heads(cfg, policy, x.device)
        q, k, v = _tp_qkv(p, x, x, cfg, policy, hs, index[:, None], index[:, None])
    else:
        q, k, v = _project_qkv(p, x, cfg, index[:, None])
    rows = torch.arange(b, device=x.device)
    slot = index % s_max if cfg.window is not None else index
    cache["k"][rows, :, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v[:, 0].to(cache["v"].dtype)
    # keys past every row's slot are masked; attend over the longest prefix
    n = min(s_max, int(index.max()) + 1 if n_keys is None else n_keys)
    valid = torch.arange(n, device=x.device)[None, :] <= slot[:, None]
    if cfg.window is not None:
        valid = valid | (index >= s_max)[:, None]
    o = decode_attention(q.transpose(1, 2), cache["k"][:, :, :n], cache["v"][:, :, :n], valid)
    if tp:
        return tp_heads_out(o, p, hs, cfg, policy, x.dtype), cache
    return o.transpose(1, 2).reshape(b, 1, -1) @ p["wo"].to(x.dtype), cache


def prefix_by_sequence(cfg, policy) -> bool:
    """Whether a split cache's prefix is sharded over the model group by
    sequence (MLA's latent prefix, which has no heads, or a model group
    that does not divide the kv heads) rather than by kv heads: the
    reference's ``cache_specs``."""
    p = policy.model_size()
    return p > 1 and (cfg.mla is not None or cfg.kv_heads % p != 0)


def _decode_qkv(p, x, cfg, policy, positions):
    """The decode step's q, k and v [b, 1, n, hd] on this rank: every head
    on one rank or with a sequence-sharded prefix (the rank's columns of
    each projection all-gathered), else the rank's heads (its columns)."""
    group = policy.model_group if prefix_by_sequence(cfg, policy) else None
    q, k, v = _projections(p, x, cfg, "qkv", group)
    return (_heads(p, q, cfg, positions, "q_norm"), _heads(p, k, cfg, positions, "k_norm"),
            _heads(p, v, cfg, positions))


def kv_all_heads(p, x, cfg, policy, positions):
    """Every kv head's k and v [b, s, kvh, hd] at ``positions`` from this
    rank's column shards of wk and wv (each projection's columns
    all-gathered over the model group): what a sequence-sharded prefix
    stores of each position."""
    k, v = _projections(p, x, cfg, "kv", policy.model_group)
    return _heads(p, k, cfg, positions, "k_norm"), _heads(p, v, cfg, positions)


def row_values(values, b: int):
    """An int for every row, or one per row, as a list of b ints (None for
    a tensor, which stays on its device)."""
    if isinstance(values, torch.Tensor):
        return None
    return [int(values)] * b if np.ndim(values) == 0 else [int(v) for v in values]


def rows_tensor(values, b: int, device):
    """(an int tensor [b], its max) of an int for every row or one per row
    (a sequence, or a tensor, whose max is then read from the device)."""
    vals = row_values(values, b)
    if vals is None:
        t = values.to(device=device, dtype=torch.long).reshape(-1).expand(b)
        return t, int(t.max())
    return torch.tensor(vals, dtype=torch.long, device=device), max(vals)


def _chunk_sums(qg, k, v, valid, m, group, compute, k_scale=None, v_scale=None):
    """Softmax attention of the grouped queries qg [b, kvh, g, hd] (in
    ``compute``'s dtype) over a chunk of keys k/v [b, kvh, n, hd], each
    row's valid ones ``valid`` [b, n], the chunks of one sequence spread
    over ``group`` (None: this rank holds all of it): the logits
    accumulated in f32 and scaled (an int8 chunk's k scales folded in),
    their max with ``m`` (the max of keys counted apart, or None) over the
    group, then the exp-weights' sum and their P.V (the weights cast to
    ``compute`` first; an int8 chunk's v scales folded into them after
    their sum), both summed over the group. Returns (o [b, kvh, g, hd],
    denom [b, kvh, g, 1], the shift m), unnormalised."""
    lp = torch.einsum("bkgd,bksd->bkgs", qg.float(), k.float()) * qg.shape[-1] ** -0.5
    if k_scale is not None:
        lp = lp * k_scale[:, :, None].float()
    lp = lp.masked_fill(~valid[:, None, None, :], NEG_INF)
    if k.shape[2]:
        top = lp.amax(dim=-1, keepdim=True)
        m = top if m is None else torch.maximum(m, top)
    elif m is None:  # no key of the chunk is read on this rank
        m = lp.new_full(lp.shape[:-1] + (1,), NEG_INF)
    m = all_reduce_max(m, group)
    wp = torch.exp(lp - m)
    denom = wp.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        wp = wp * v_scale[:, :, None].float()
    o = torch.einsum("bkgs,bksd->bkgd", wp.to(compute).float(), v.float())
    if group is None:
        return o, denom, m
    both = all_reduce_sum(torch.cat([o, denom], dim=-1), group)
    return both[..., :-1], both[..., -1:], m


def _decode_out(o, p, x, policy, by_seq: bool):
    """A decode step's attention output [b, 1, n*hd] through ``wo``: over
    a model group row-parallel, fed this rank's heads (of every head's
    output when ``by_seq``), the partial products summed."""
    if by_seq:
        o = scatter_to(o, -1, policy.model_group)
    return reduce_from(o @ p["wo"].to(x.dtype), policy.model_group)


def _ring_decode(p, x, cache, index, cfg, policy, n_keys=None):
    """One decode step over a sliding window's ring sharded over the model
    group by sequence (``prefix_by_sequence``): rank m holds slots m S/P ..
    (m + 1) S/P - 1 of every kv head of the ring of S slots. Each row's new
    k/v go to its slot index % S on the rank that owns it; every rank
    takes every head (``_decode_qkv``) and attends over its slots that the
    row reads (at or before its slot, or all once it has wrapped, index >=
    S), the group combining the chunks (``_chunk_sums``: the max, then the
    rescaled sums and P.V), with no tail. ``wo`` is fed this rank's heads
    of the result (``_decode_out``)."""
    b, hd, dev = x.shape[0], cfg.head_dim_, x.device
    s_loc = cache["k"].shape[2]
    ring = s_loc * policy.model_size()
    lo = policy.model_rank() * s_loc
    q, k, v = _decode_qkv(p, x, cfg, policy, index[:, None])
    rows = torch.arange(b, device=dev)
    slot = index % ring
    mine = (slot >= lo) & (slot < lo + s_loc)
    at = (slot - lo).clamp(0, s_loc - 1)
    for name, t in (("k", k), ("v", v)):
        held = cache[name][rows, :, at]
        cache[name][rows, :, at] = torch.where(mine[:, None, None], t[:, 0].to(held.dtype), held)
    # the slots of this rank that some row reads
    n_p = max(0, min(s_loc, min(ring, int(index.max()) + 1 if n_keys is None else n_keys) - lo))
    pos = lo + torch.arange(n_p, device=dev)
    valid = (pos[None, :] <= slot[:, None]) | (index >= ring)[:, None]
    nq, nkv = q.shape[2], k.shape[2]
    dtype = cache["k"].dtype
    qg = q[:, 0].reshape(b, nkv, nq // nkv, hd).to(dtype)
    o, denom, _ = _chunk_sums(qg, cache["k"][:, :, :n_p], cache["v"][:, :, :n_p], valid, None,
                              policy.model_group, dtype)
    o = (o / denom).reshape(b, 1, nq * hd).to(x.dtype)
    return _decode_out(o, p, x, policy, True), cache


def _attn_decode_split(p, x, cache, index, cfg, policy, prefix_len):
    """Decode against a read-only prefix and a small tail (the reference's
    ``_attn_decode_split``, ``attention.py:262-315``), each row masked to
    its valid part: prefix positions below its ``prefix_len`` (default the
    whole prefix, the reference's assumption) and tail slots up to its new
    token, which goes to slot index - prefix_len. The reference attends
    over every prefix position and writes slot index - S, which clamps to
    0 until the prompt fills the prefix: right only for a full prefix.

    As the reference: the cache operands in their storage dtype (int8
    dequantized to bf16), logits accumulated in f32 and scaled, the int8
    prefix's k scales folded into its logits and its v scales into its
    softmax weights after their sum, the two segments combined flash-decode
    style, the weights cast to the cache dtype before P.V.

    Over a model group the prefix is sharded by kv heads (this rank's q
    heads attend its kv heads; ``wo`` row-parallel) or by sequence
    (``prefix_by_sequence``): every rank takes every head, attends over its
    chunk of the prefix, and the group combines the chunks (the max, then
    the rescaled sums and P.V, ``_chunk_sums``); the replicated tail is
    counted once, after the sum. ``wo`` is then fed this rank's heads of
    the combined output."""
    b = x.shape[0]
    hd = cfg.head_dim_
    dev = x.device
    by_seq = prefix_by_sequence(cfg, policy)
    s_loc = cache["k"].shape[2]
    plen, max_plen = rows_tensor(s_loc * policy.model_size() if prefix_len is None else prefix_len,
                                 b, dev)
    q, k, v = _decode_qkv(p, x, cfg, policy, index[:, None])
    slot = index - plen
    rows = torch.arange(b, device=dev)
    cache["tk"][rows, :, slot] = k[:, 0].to(cache["tk"].dtype)
    cache["tv"][rows, :, slot] = v[:, 0].to(cache["tv"].dtype)
    # the prefix positions this rank holds that some row attends to
    lo = policy.model_rank() * s_loc if by_seq else 0
    n_p = max(0, min(s_loc, max_plen - lo))
    quant = "k_scale" in cache
    kv_compute = torch.bfloat16 if quant else cache["k"].dtype
    nq, nkv = q.shape[2], k.shape[2]
    qg = q[:, 0].reshape(b, nkv, nq // nkv, hd).to(kv_compute)
    scale = hd ** -0.5
    tk, tv = cache["tk"], cache["tv"]
    # a product of two values of the compute dtype is exact in f32
    lt = torch.einsum("bkgd,bktd->bkgt", qg.to(tk.dtype).float(), tk.float()) * scale
    valid = torch.arange(tk.shape[2], device=dev)[None, :] <= slot[:, None]
    lt = lt.masked_fill(~valid[:, None, None, :], NEG_INF)
    scales = ({"k_scale": cache["k_scale"][:, :, :n_p], "v_scale": cache["v_scale"][:, :, :n_p]}
              if quant else {})
    valid = (lo + torch.arange(n_p, device=dev))[None, :] < plen[:, None]
    o, denom, m = _chunk_sums(qg, cache["k"][:, :, :n_p], cache["v"][:, :, :n_p], valid,
                              lt.amax(dim=-1, keepdim=True), policy.model_group if by_seq else None,
                              kv_compute, **scales)
    wt = torch.exp(lt - m)  # the tail's, once, after the chunks' sum
    o = o + torch.einsum("bkgt,bktd->bkgd", wt.to(tv.dtype).float(), tv.float())
    denom = denom + wt.sum(dim=-1, keepdim=True)
    o = (o / denom).reshape(b, 1, nq * hd).to(x.dtype)
    return _decode_out(o, p, x, policy, by_seq), cache


def flush_tail(cache, prefix_valid, *, chunk=(0, 1)):
    """Write the tail into the prefix (the reference's ``flush_tail``,
    ``attention.py:318-330``), each row's ``TAIL_LEN`` tail entries at its
    valid prefix length ``prefix_valid`` (an int or one per row), then
    zero the tail. An int8 prefix takes the entries quantized (``quantize_kv``) with
    their scales; the reference's flush writes bf16 values into it, which
    raises, and returns no scales. MLA's cache flushes tckv into ckv and
    tkr into kr the same way, along its sequence dim 1 (the reference's
    flush knows only k and v). ``chunk`` = (m, P): this cache holds
    chunk m of P of a sequence-sharded prefix, and writes only the
    positions in it. In place; returns the cache."""
    pairs = (("ckv", "tckv"), ("kr", "tkr")) if "tckv" in cache else (("k", "tk"), ("v", "tv"))
    seq = 1 if "tckv" in cache else 2  # the position dim of a leaf
    b, s_loc = cache[pairs[0][0]].shape[0], cache[pairs[0][0]].shape[seq]
    t = cache[pairs[0][1]].shape[seq]
    m, parts = chunk
    quant = "k_scale" in cache
    lo_c = m * s_loc

    def at(r, lo, hi):  # row r's positions lo..hi-1 of a leaf
        return (r,) + (slice(None),) * (seq - 1) + (slice(lo, hi),)

    for r, start in enumerate(row_values(prefix_valid, b)):
        if start + t > s_loc * parts:
            raise ValueError(f"row {r}: a tail of {t} at {start} overflows a prefix of "
                             f"{s_loc * parts}")
        lo, hi = max(start, lo_c), min(start + t, lo_c + s_loc)
        if hi <= lo:
            continue
        for name, tail in pairs:
            src = cache[tail][at(r, lo - start, hi - start)]
            if quant:
                src, sc = quantize_kv(src)
                cache[name + "_scale"][at(r, lo - lo_c, hi - lo_c)] = sc
            cache[name][at(r, lo - lo_c, hi - lo_c)] = src.to(cache[name].dtype)
    for _, tail in pairs:
        cache[tail].zero_()
    return cache


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


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2). Per-head no-RoPE dims
# attend against up-projections of a compressed latent; one shared RoPE key
# rides alongside. The cache holds the latent and the RoPE key.
# ---------------------------------------------------------------------------

def init_mla_params(cfg, normal, ones) -> dict:
    """MLA's leaves with the reference's shapes and scales; ``normal(name,
    shape, std)`` and ``ones(name, shape)`` make (and finish) a leaf."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    std = d ** -0.5
    return {
        "wq": normal("wq", (d, h * (m.dh_nope + m.dh_rope)), std),
        "w_dkv": normal("w_dkv", (d, m.kv_lora + m.dh_rope), std),
        "kv_norm": ones("kv_norm", (m.kv_lora,)),
        "k_up": normal("k_up", (m.kv_lora, h * m.dh_nope), m.kv_lora ** -0.5),
        "v_up": normal("v_up", (m.kv_lora, h * m.dh_v), m.kv_lora ** -0.5),
        "wo": normal("wo", (h * m.dh_v, d), std),
    }


def _mla_qkr(p, x, cfg, positions):
    """x: [b, s, d] -> q_nope [b, s, n, dh_nope], q_rope [b, s, n, dh_rope]
    (rotated) for the n heads of ``p``'s wq (all of them, or this rank's),
    the normed latent ckv [b, s, kv_lora] (through the RMSNorm kernel) and
    the rotated shared key k_rope [b, s, dh_rope]."""
    m = cfg.mla
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, -1, m.dh_nope + m.dh_rope)
    q_nope, q_rope = q[..., : m.dh_nope], q[..., m.dh_nope:]
    q_rope = layers.apply_rope(q_rope, positions, theta=cfg.rope_theta)
    dkv = x @ p["w_dkv"].to(x.dtype)
    ckv = layers.rms_norm(dkv[..., : m.kv_lora].contiguous(), p["kv_norm"])
    k_rope = layers.apply_rope(dkv[:, :, None, m.kv_lora:], positions, theta=cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def _mla_attend(p, q_nope, q_rope, ckv, k_rope, cfg):
    """Causal attention of q's n heads over the latent: per-head k and v
    up-projected by ``p``'s k_up and v_up columns of those heads, one
    flash-attention launch at head dim dh_nope + dh_rope with v zero-padded
    to it (the output's extra columns are zeros and are sliced off).
    Returns [b, s, n * dh_v]."""
    m = cfg.mla
    b, s, n, _ = q_nope.shape
    dtype = q_nope.dtype
    k_nope = (ckv @ p["k_up"].to(dtype)).reshape(b, s, n, m.dh_nope)
    v = (ckv @ p["v_up"].to(dtype)).reshape(b, s, n, m.dh_v)
    dq = m.dh_nope + m.dh_rope
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, n, m.dh_rope)], dim=-1)
    v = F.pad(v, (0, dq - m.dh_v))
    o = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=True, scale=dq ** -0.5)
    return o.transpose(1, 2)[..., : m.dh_v].reshape(b, s, n * m.dh_v)


def mla_forward(p, x, cfg, policy=LOCAL, *, positions=None, return_latents=False,
                seq_sharded: bool = False):
    """Full-sequence causal MLA (training, prefill): x [b, s, d] -> [b, s,
    d] through ``_mla_attend``. Returns out, and with ``return_latents``
    also the (ckv, k_rope) of every position, which the cache keeps. Under
    a policy whose model group has more than one rank, ``p`` holds this
    rank's shards and x the residual stream as the block holds it (this
    rank's slice of the sequence with ``seq_sharded``): ``_mla_tp``."""
    if policy.model_size() > 1:
        out, ckv, k_rope = _mla_tp(p, x, cfg, policy, seq_sharded, positions)
    else:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q_nope, q_rope, ckv, k_rope = _mla_qkr(p, x, cfg, positions)
        out = _mla_attend(p, q_nope, q_rope, ckv, k_rope, cfg) @ p["wo"].to(x.dtype)
    return (out, ckv, k_rope) if return_latents else out


def _mla_tp(p, x, cfg, policy, seq_sharded: bool, positions=None):
    """``mla_forward`` over the model group, the reference's specs: ``p``
    holds this rank's columns of wq, k_up and v_up (its h/P heads) and its
    rows of wo; w_dkv and kv_norm whole. Every rank takes the whole
    sequence in (``layers.tp_in``) and computes the latent ckv and k_rope
    of every position, which feed its own heads only: w_dkv and kv_norm
    enter through ``copy_to``, so that their gradient, a part on each rank,
    is summed over the group. Returns (out, ckv, k_rope), the latents of
    the whole sequence."""
    group = policy.model_group
    xin = layers.tp_in(x, group, seq_sharded)
    if positions is None:
        positions = torch.arange(xin.shape[1], device=x.device)
    local = dict(p, w_dkv=copy_to(p["w_dkv"], group), kv_norm=copy_to(p["kv_norm"], group))
    q_nope, q_rope, ckv, k_rope = _mla_qkr(local, xin, cfg, positions)
    o = _mla_attend(local, q_nope, q_rope, ckv, k_rope, cfg)
    return layers.tp_out(o @ p["wo"].to(x.dtype), group, seq_sharded), ckv, k_rope


def init_mla_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None, *,
                   split: bool = False) -> dict:
    """Zeroed MLA cache: latent [batch, max_len, kv_lora] and RoPE key
    [batch, max_len, dh_rope]; ``split`` adds the reference's tail tckv
    [batch, TAIL_LEN, kv_lora] and tkr [batch, TAIL_LEN, dh_rope] beside
    the read-only prefix (every MLA cache under a mesh policy)."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_leaves(cfg, batch, max_len, dtype, split=split).items()}


def _mla_absorbed_q(p, q_nope, q_rope, cfg):
    """A decode step's q_lat [b, n, kv_lora] = q_nope k_up^T (k_up absorbed
    into q, in f32 as the reference) and qr [b, n, dh_rope] f32, for the n
    heads of ``p``'s k_up."""
    m = cfg.mla
    k_up = p["k_up"].reshape(m.kv_lora, -1, m.dh_nope)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), k_up.float())
    return q_lat, q_rope[:, 0].float()


def _mla_logits(q_lat, qr, ckv, kr, cfg):
    """Scaled logits [b, h, s] of the absorbed q against a segment of the
    latent cache, q cast to the cache dtype and accumulated in f32 (a
    product of two values of the cache dtype is exact in f32)."""
    m = cfg.mla
    logits = torch.einsum("bhl,bsl->bhs", q_lat.to(ckv.dtype).float(), ckv.float())
    logits = logits + torch.einsum("bhr,bsr->bhs", qr.to(kr.dtype).float(), kr.float())
    return logits * (m.dh_nope + m.dh_rope) ** -0.5


def _mla_out(p, o_lat, x, cfg):
    """The latent output o_lat [b, n, kv_lora] f32 of ``p``'s n heads times
    their v_up columns in f32, cast to x's dtype, times their rows of wo."""
    m = cfg.mla
    b, n, _ = o_lat.shape
    v_up = p["v_up"].reshape(m.kv_lora, n, m.dh_v)
    o = torch.einsum("bhl,lhv->bhv", o_lat, v_up.float()).reshape(b, 1, n * m.dh_v).to(x.dtype)
    return o @ p["wo"].to(x.dtype)


def mla_decode(p, x, cache, index, cfg, n_keys=None, *, policy=LOCAL, prefix_len=None):
    """One absorbed-projection decode step for every row: attention runs in
    the latent space, so a cached token costs kv_lora + dh_rope values.

    x: [b, 1, d]; cache {"ckv", "kr"}: [b, S, ...], updated in place at each
    row's ``index`` (int tensor [b]); ``n_keys`` = max(index) + 1 when the
    caller knows it. As the reference: k_up absorbed into q in f32, q's
    latent and RoPE parts cast to the cache dtype, logits accumulated in
    f32, f32 softmax, the latent output and v_up in f32, the result cast to
    x's dtype before ``wo``. Returns (out [b, 1, d], cache).

    A split cache (a "tckv" leaf; every MLA cache under a mesh policy)
    goes to ``_mla_decode_split``, with each row's valid prefix length
    ``prefix_len``."""
    if "tckv" in cache:
        return _mla_decode_split(p, x, cache, index, cfg, policy, prefix_len)
    if policy.model_size() > 1:
        raise ValueError("a decode step over a model group takes a split cache")
    q_nope, q_rope, ckv, k_rope = _mla_qkr(p, x, cfg, index[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    cache["ckv"][rows, index] = ckv[:, 0].to(cache["ckv"].dtype)
    cache["kr"][rows, index] = k_rope[:, 0].to(cache["kr"].dtype)
    n = int(index.max()) + 1 if n_keys is None else n_keys
    ckv_c, kr_c = cache["ckv"][:, :n], cache["kr"][:, :n]
    q_lat, qr = _mla_absorbed_q(p, q_nope, q_rope, cfg)
    logits = _mla_logits(q_lat, qr, ckv_c, kr_c, cfg)
    valid = torch.arange(n, device=x.device)[None, :] <= index[:, None]
    w = torch.softmax(logits.masked_fill(~valid[:, None, :], NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", w, ckv_c.float())
    return _mla_out(p, o_lat, x, cfg), cache


def _mla_decode_split(p, x, cache, index, cfg, policy, prefix_len):
    """The absorbed decode against a read-only latent prefix and a
    ``TAIL_LEN`` tail (the reference's ``mla_decode`` split branch,
    ``attention.py:441-460``), each row masked to its valid part as
    ``_attn_decode_split`` masks it: prefix positions below its
    ``prefix_len`` (default the whole prefix) and tail slots up to its new
    token, which every rank writes (the latent is the same on each) at
    slot index - prefix_len. The reference leaves the prefix unmasked and
    writes slot index - S, which clamps to 0 until the prompt fills the
    prefix: right only for a full prefix.

    As the reference: the cache operands in their dtype, logits
    accumulated in f32, the two segments combined flash-decode style, the
    unnormalised weights cast to the cache dtype before P.V.

    Over a model group the prefix is sharded by sequence: this rank's
    heads' q_lat and qr are all-gathered (every head reads each chunk),
    each rank attends over its chunk, the group combines the chunks (one
    max, then one sum of the latent outputs and denominators), the
    replicated tail is counted once after the sum, and this rank's heads
    of the result go through its v_up columns and wo rows: four
    collectives a layer."""
    b = x.shape[0]
    dev = x.device
    group, size = policy.model_group, policy.model_size()
    kv_lora = cfg.mla.kv_lora
    s_loc = cache["ckv"].shape[1]
    plen, max_plen = rows_tensor(s_loc * size if prefix_len is None else prefix_len, b, dev)
    q_nope, q_rope, ckv, k_rope = _mla_qkr(p, x, cfg, index[:, None])
    slot = index - plen
    rows = torch.arange(b, device=dev)
    cache["tckv"][rows, slot] = ckv[:, 0].to(cache["tckv"].dtype)
    cache["tkr"][rows, slot] = k_rope[:, 0].to(cache["tkr"].dtype)
    q_lat, qr = _mla_absorbed_q(p, q_nope, q_rope, cfg)
    if size > 1:  # every head: [b, h, kv_lora + dh_rope]
        both = gather_from(torch.cat([q_lat, qr], dim=-1), 1, group)
        q_lat, qr = both[..., :kv_lora], both[..., kv_lora:]
    # the prefix positions this rank holds that some row attends to
    lo = policy.model_rank() * s_loc
    n_p = max(0, min(s_loc, max_plen - lo))
    cp, kp = cache["ckv"][:, :n_p], cache["kr"][:, :n_p]
    tc, tr = cache["tckv"], cache["tkr"]
    lp = _mla_logits(q_lat, qr, cp, kp, cfg)
    valid = (lo + torch.arange(n_p, device=dev))[None, :] < plen[:, None]
    lp = lp.masked_fill(~valid[:, None, :], NEG_INF)
    lt = _mla_logits(q_lat, qr, tc, tr, cfg)
    valid = torch.arange(tc.shape[1], device=dev)[None, :] <= slot[:, None]
    lt = lt.masked_fill(~valid[:, None, :], NEG_INF)
    m = lt.amax(dim=-1, keepdim=True)
    if n_p:
        m = torch.maximum(m, lp.amax(dim=-1, keepdim=True))
    if size > 1:
        m = all_reduce_max(m, group)
    wp, wt = torch.exp(lp - m), torch.exp(lt - m)
    o = torch.einsum("bhs,bsl->bhl", wp.to(cp.dtype).float(), cp.float())
    denom = wp.sum(dim=-1, keepdim=True)
    if size > 1:  # the chunks' sums over the group, then the tail's once
        both = all_reduce_sum(torch.cat([o, denom], dim=-1), group)
        o, denom = both[..., :kv_lora], both[..., kv_lora:]
    o = o + torch.einsum("bht,btl->bhl", wt.to(tc.dtype).float(), tc.float())
    denom = denom + wt.sum(dim=-1, keepdim=True)
    o_lat = o / denom
    if size == 1:
        return _mla_out(p, o_lat, x, cfg), cache
    # this rank's heads: its columns of v_up, its rows of wo
    return reduce_from(_mla_out(p, scatter_to(o_lat, 1, group), x, cfg), group), cache
