"""Plain PyTorch version of the flash-attention kernel.

It mirrors the arithmetic of the TPU kernel ``flash_attention_pallas``
(and so of the CUDA kernel that replaces it), not ``attention_ref``: q, k
and v are upcast to f32 before the logits are formed, masked logits are
-1e30, the softmax is normalised by ``max(l, 1e-30)``, and the result is
cast to q's dtype once. ``attention_ref`` forms the logits in the input
dtype, which at bf16 differs from the kernel by about 1% of max|logit|.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [b, h, sq, d]; k/v: [b, kvh, sk, d] with h % kvh == 0 (query head
    i reads kv head i // (h // kvh)). Causal: query i sees key j iff
    j <= i + sk - sq. Returns [b, h, sq, d] in q's dtype."""
    _, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kf = k.float().repeat_interleave(h // kvh, dim=1)
    vf = v.float().repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / torch.clamp(l, min=1e-30)
    return o.to(q.dtype)
