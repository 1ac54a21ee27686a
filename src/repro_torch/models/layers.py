"""Shared LM layers: norms, RoPE, embeddings, MLPs, chunked cross-entropy, last-token logits.

Port of ``repro.models.layers`` (``layers.py:16-138``; the chunked
cross-entropy forward only), and the depthwise causal conv that the
reference's SSM and RG-LRU mixers each define. Weights are cast to the
activation dtype at each matmul as in the reference (``.to(x.dtype)``,
a no-op when the serving runner already holds them in that dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as rmsnorm_ops


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, w, *, eps=1e-6):
    """RMSNorm through the fused kernel (its plain version for CPU tensors)."""
    return rmsnorm_ops.rmsnorm(x, w, eps=eps)


def layer_norm(x, w, b, *, eps=1e-5):
    """LayerNorm (whisper's) in plain PyTorch, as the reference computes
    it: f32 mean and population variance, ``rsqrt(var + eps) * w + b``,
    cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


# ---------------------------------------------------------------------------
# Depthwise causal conv (the Mamba-2 and RG-LRU mixers')
# ---------------------------------------------------------------------------

def causal_conv(x, w, b):
    """Depthwise causal conv, as ``_causal_conv`` in the reference's
    ``ssm.py`` and ``rglru.py``. x: [b, s, c]; w: [k, c], b: [c], both cast
    to x's dtype at use; the k taps summed in order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = w.to(x.dtype)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (GPT-NeoX half-split convention; optional
# partial fraction as in ChatGLM's scheme, which rotates half the head dim).
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0, device=None):
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exponents = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / (theta ** exponents)
    return inv, rot


def apply_rope(x, positions, *, theta=10000.0, fraction=1.0):
    """x: [b, s, h, d]; positions: [s] or [b, s] token positions."""
    d = x.shape[-1]
    inv, rot = rope_frequencies(d, theta, fraction, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv  # [b, s, rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(table, tokens, *, scale_by_sqrt_dim=False):
    """table: [V, D]; tokens: int [b, s] -> [b, s, D] in the table's dtype."""
    x = table[tokens]
    if scale_by_sqrt_dim:
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def glu_mlp(x, w_gate, w_up, w_down, *, act: str = "swiglu"):
    """Gated MLP: swiglu (silu gate) or geglu (tanh-gelu gate, gemma)."""
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    if act == "swiglu":
        g = F.silu(g)
    elif act == "geglu":
        g = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(act)
    return (g * u) @ w_down.to(x.dtype)


def gelu_mlp(x, w1, b1, w2, b2, *, act: str = "gelu"):
    """Biased two-matrix MLP: the exact (erf) GELU (whisper's) or
    minitron's squared ReLU."""
    h = x @ w1.to(x.dtype) + b1.to(x.dtype)
    if act == "gelu":
        h = F.gelu(h)
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(act)
    return h @ w2.to(x.dtype) + b2.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy (forward): never builds [b, s, V] logits, only
# [b, chunk, V] at a time.
# ---------------------------------------------------------------------------

def chunked_cross_entropy(h, lm_head, targets, *, chunk: int = 512):
    """Mean token cross-entropy of ``h @ lm_head`` against ``targets``.
    h: [b, s, d]; lm_head: [d, V]; targets: int [b, s]. As the reference:
    the sequence in chunks of min(chunk, s) (which must divide s), f32
    logits, ``logsumexp - logit[target]`` summed in f32 chunk by chunk."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    w = lm_head.to(h.dtype)
    for i in range(0, s, chunk):
        logits = (h[:, i:i + chunk] @ w).float()
        tgt = logits.gather(-1, targets[:, i:i + chunk, None].long())[..., 0]
        total = total + (torch.logsumexp(logits, dim=-1) - tgt).sum()
    return total / (b * s)


def logits_last(h_last, lm_head):
    """Decode-time logits for the last position only. h_last: [b, d]."""
    return (h_last @ lm_head.to(h_last.dtype)).float()
