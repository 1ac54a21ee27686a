"""Shared LM layers: norms, RoPE, embeddings, MLPs, chunked cross-entropy, last-token logits.

Port of ``repro.models.layers`` (``layers.py:16-138``), and the
depthwise causal conv that the reference's SSM and RG-LRU mixers each
define. Weights are cast to the activation dtype at each matmul as in the
reference (``.to(x.dtype)``, a no-op when the serving runner already holds
them in that dtype).

Under a mesh policy two of them run tensor-parallel over the model group,
on this rank's shards of the weights (``param_specs``): ``tp_mlp``
(column-parallel w_gate/w_up or w1/b1, row-parallel w_down or w2) and the
vocab-parallel ``chunked_cross_entropy`` (lm_head's columns: the logits'
max and sum of exponentials over the group, the target's logit from the
rank that holds it), where the reference shards the logits over the model
axis (``layers.py:107-133``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import (
    all_gather, all_reduce_max, copy_to, reduce_from, reduce_scatter,
)
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

def embed(table, tokens, *, scale_by_sqrt_dim=False, dim=None):
    """table: [V, D]; tokens: int [b, s] -> [b, s, D] in the table's dtype,
    scaled by the square root of ``dim`` (default D) if asked: a table of
    some of d_model's columns is scaled by the whole width's."""
    x = table[tokens]
    if scale_by_sqrt_dim:
        width = table.shape[-1] if dim is None else dim
        x = x * torch.tensor(width ** 0.5, dtype=x.dtype, device=x.device)
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


def tp_in(x, group, seq_sharded: bool):
    """The residual stream entering a tensor-parallel block: the whole
    sequence (an all-gather of this rank's slice under ``seq_shard``),
    whose every rank computes its own columns, so the backward sums the
    ranks' cotangents (a reduce-scatter, or an all-reduce)."""
    return all_gather(x, 1, group) if seq_sharded else copy_to(x, group)


def tp_out(y, group, seq_sharded: bool):
    """A row-parallel product's partial sums leaving the block: summed
    over the group (reduce-scattered to this rank's slice of the sequence
    under ``seq_shard``)."""
    return reduce_scatter(y, 1, group) if seq_sharded else reduce_from(y, group)


def tp_mlp(x, p, act: str, group, seq_sharded: bool):
    """The MLP over the model group on this rank's shards of ``p``
    (w_gate/w_up or w1/b1 column-parallel, w_down or w2 row-parallel; b2
    whole, added once after the sum). x: the residual stream as the block
    holds it."""
    h = tp_in(x, group, seq_sharded)
    if act in ("swiglu", "geglu"):
        return tp_out(glu_mlp(h, p["w_gate"], p["w_up"], p["w_down"], act=act), group,
                      seq_sharded)
    y = tp_out(gelu_mlp(h, p["w1"], p["b1"], p["w2"], torch.zeros_like(p["b2"]), act=act),
               group, seq_sharded)
    # on a slice of the sequence b2's gradient is this rank's part of it
    b2 = copy_to(p["b2"], group) if seq_sharded else p["b2"]
    return y + b2.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy (forward): never builds [b, s, V] logits, only
# [b, chunk, V] at a time.
# ---------------------------------------------------------------------------

def chunked_cross_entropy(h, lm_head, targets, *, chunk: int = 512, vocab_group=None):
    """Mean token cross-entropy of ``h @ lm_head`` against ``targets``.
    h: [b, s, d]; lm_head: [d, V]; targets: int [b, s]. As the reference:
    the sequence in chunks of min(chunk, s) (which must divide s), f32
    logits, ``logsumexp - logit[target]`` summed in f32 chunk by chunk.

    With ``vocab_group`` lm_head is this rank's [d, V/P] columns (rank r
    holds vocab entries r V/P ..): the log-sum-exp takes the group's max
    and sums the exponentials over the group, and the target's logit comes
    from the rank that holds it, so every rank returns the whole loss."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    w = lm_head.to(h.dtype)
    for i in range(0, s, chunk):
        logits = (h[:, i:i + chunk] @ w).float()
        t = targets[:, i:i + chunk].long()
        if vocab_group is None:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, t[..., None])[..., 0]
        else:
            v = logits.shape[-1]
            m = all_reduce_max(logits.detach().amax(dim=-1), vocab_group)
            lse = m + torch.log(reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                                            vocab_group))
            local = t - vocab_group.rank() * v
            mine = (local >= 0) & (local < v)
            tgt = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
            tgt = reduce_from(torch.where(mine, tgt, torch.zeros_like(tgt)), vocab_group)
        total = total + (lse - tgt).sum()
    return total / (b * s)


def logits_last(h_last, lm_head):
    """Decode-time logits for the last position only. h_last: [b, d]."""
    return (h_last @ lm_head.to(h_last.dtype)).float()
