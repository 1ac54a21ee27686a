"""Plain PyTorch version of the fused RMSNorm (copy of ``rmsnorm_ref``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d]; w: [d]. f32 statistics, output in x's dtype; plain
    ``x_hat * w`` (callers add 1 for the gemma-style convention)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)
