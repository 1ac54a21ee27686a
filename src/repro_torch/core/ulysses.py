"""Sequence-parallel attention through the paper's repartition operator.

Port of ``repro.core.ulysses`` (``ulysses.py:27-87``). The FNO block moves
the sharded spatial dim so that the FFT is local; attention needs the
whole sequence per head, and the same all-to-all (DeepSpeed-Ulysses)
gives it:

    q,k,v [b, s/P, h, d]  --R_{s->h}-->  [b, s, h/P, d]
    local attention over the whole sequence for h/P heads
    o     [b, s, h/P, d]  --R_{h->s}-->  [b, s/P, h, d]

GQA: when P divides the kv heads the same repartition moves k and v;
otherwise k and v are all-gathered along the sequence (cheap when the kv
heads are few) and each rank takes the kv head that serves each of its q
heads. The all-gather's backward is a reduce-scatter (each rank uses its
own kv heads), the repartitions' the reverse all-to-all
(``core/repartition.py``), so the whole is differentiable; every rank
must run it, and its backward, in the same order.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import all_gather
from repro_torch.core.repartition import repartition


def ulysses_attention(q, k, v, group, *, causal: bool = True, scale: Optional[float] = None,
                      attn_fn=None):
    """q/k/v: this rank's sequence shards [b, s/P, h(kv), d] over ``group``
    -> [b, s/P, h, d]. ``attn_fn(q, k, v, causal=, scale=)`` computes
    attention in the [b, s, h, d] layout (default ``_dense_attention``;
    on the card a caller passes ``flash_attn_fn``)."""
    p, r = group.size(), group.rank()
    h, kvh = q.shape[2], k.shape[2]
    if h % p:
        raise ValueError(f"heads {h} not divisible by axis size {p}")
    hp = h // p
    q = repartition(q, 1, 2, group)
    if kvh % p == 0:
        k = repartition(k, 1, 2, group)
        v = repartition(v, 1, 2, group)
    else:
        # few kv heads (GQA/MQA): gather the sequence, then take the kv
        # head(s) serving this rank's q heads: one per run of q heads when
        # the runs fall evenly on the ranks (GQA kept), else one per q head
        k = all_gather(k, 1, group)
        v = all_gather(v, 1, group)
        kv_idx = kv_heads_for(r * hp, hp, h, kvh, q.device)
        k = k.index_select(2, kv_idx)
        v = v.index_select(2, kv_idx)
    o = (attn_fn or _dense_attention)(q, k, v, causal=causal, scale=scale)
    return repartition(o, 2, 1, group)


def flash_attn_fn(q, k, v, *, causal: bool, scale: Optional[float]):
    """The flash-attention wrapper as an ``attn_fn``: [b, s, h, d] in and
    out, the kernel's [b, h, s, d] as strided views."""
    from repro_torch.kernels import flash_attention as flash_ops

    o = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, scale=scale)
    return o.transpose(1, 2)


def kv_heads_for(first: int, n: int, h: int, kvh: int, device=None):
    """The kv heads serving q heads ``first .. first + n - 1`` of ``h`` (q
    head i reads kv head i // (h // kvh)), as an index tensor whose GQA
    mapping onto the n q heads is the same: one kv head per run of q heads
    when the n heads hold whole runs, or lie inside one, else one per q
    head."""
    group = h // kvh
    if n % group == 0 or (group % n == 0 and first % n == 0):
        return torch.arange(first // group, (first + n - 1) // group + 1, device=device)
    return (first + torch.arange(n, device=device)) // group


def _dense_attention(q, k, v, *, causal: bool, scale: Optional[float]):
    """Plain attention in the [b, s, h, d] layout, as the reference's:
    logits in q's dtype, the softmax in float32 cast back before P.V."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        sk = k.shape[1]
        mask = torch.ones((s, sk), dtype=torch.bool, device=q.device).tril(sk - s)
        logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
