"""Whisper-style encoder-decoder (audio frontend stubbed): parameters, loss, prefill, decode.

Port of ``repro.models.whisper`` under the local policy, and its
tensor-parallel specs (``whisper_param_specs``, as tuples); a mesh policy
over a model group of more than one rank raises ``NOT_PORTED`` (ROADMAP
Queue 1 item 5d). The conv/mel frontend is a stub: the inputs are
precomputed frame embeddings [b, frames, d_model]. Encoder: bidirectional
self-attention + GELU MLP, sinusoidal positions. Decoder: causal
self-attention + cross-attention + GELU MLP, sinusoidal positions too.
LayerNorms with bias throughout (eps 1e-5, as the reference fixes it).
Parameters keep the reference's tree, each stack of layers on a leading
layer dim::

    {"enc": {"layers": {"attn": {"wq", "wk", "wv", "wo", "bq", "bk", "bv"},
                        "mlp": {"w1", "b1", "w2", "b2"},
                        "ln1": {"w", "b"}, "ln2": {"w", "b"}},
             "final_ln": {"w", "b"}},
     "dec": {"embed": [V, d],
             "layers": {"self_attn", "cross_attn", "mlp", "ln1", "ln2", "ln3"},
             "final_ln", "lm_head": [d, V]}}

and the cache {"self": {"k", "v"}: [L, b, kvh, max_len, hd], "cross_k",
"cross_v": [L, b, kvh, frames, hd]}, bf16 whatever the activation dtype,
as the reference's. ``whisper_decode_step`` updates the self cache in
place.

Routing, as the reference's: the encoder's self-attention, every
cross-attention (the decode step's too, one query row) and
``decode_train``'s causal self-attention go through the flash kernel; the
prefill's decoder self-attention is the plain version, which the
reference takes there (it calls flash without ``use_pallas``); the decode
step's self-attention is the plain ``attn_decode``. At L encoder and L
decoder layers: 2 L flash launches a prefill, L a decode step, 3 L a
``whisper_loss``; no RMSNorm.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import transformer as tf_lib
from repro_torch.models.policy import LOCAL, MODEL_AXIS, ParallelPolicy

# leaves that stay float32 in a serving draw: the embedding table and the
# LayerNorms' weight and bias (the reference computes the norm in f32 with
# them); every other leaf is a matmul weight or bias, cast at its matmul
F32_LEAVES = ("embed", "w", "b")
LN_EPS = 1e-5

# the tree walks are the LM's
whisper_params_from_numpy = tf_lib.lm_params_from_numpy
whisper_params_to_numpy = tf_lib.lm_params_to_numpy


def _sinusoid(positions, d: int):
    """[n] positions -> [n, d] float32: sin then cos of positions times
    exp(-ln(10000) i / (half - 1)), i < half = d // 2 (the reference's
    divisor, ``half - 1``)."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * i / (half - 1))
    ang = positions[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(x, p):
    return layers.layer_norm(x, p["w"], p["b"], eps=LN_EPS)


def _mlp(h, p):
    return layers.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"])


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_whisper_params(cfg, *, generator: torch.Generator, device=None,
                        serving: bool = False) -> dict:
    """Random float32 parameters with the reference's tree, scales and
    stacking, drawn from ``generator`` (which must live on ``device``) one
    leaf at a time. With ``serving`` each leaf is cast as soon as it is
    drawn (matmul weights and biases to the activation dtype,
    ``F32_LEAVES`` float32), so the float32 masters never coexist."""
    device = resolve_device(device)
    d = cfg.d_model
    act = cfg.activation_dtype
    finish = ((lambda name, t: t.to(torch.float32 if name in F32_LEAVES else act))
              if serving else (lambda name, t: t))

    def ln(mk):
        return {"w": mk.const("w", (d,), 1.0), "b": mk.const("b", (d,), 0.0)}

    def stack(n, attns, norms):
        mk = tf_lib.leaf_makers((n,), generator, device, finish)
        p = {name: tf_lib._init_attn(cfg, mk.normal, mk.const) for name in attns}
        p["mlp"] = tf_lib._init_mlp(d, cfg.d_ff, "gelu", mk.normal, mk.const)
        p.update({name: ln(mk) for name in norms})
        return p

    one = tf_lib.leaf_makers((), generator, device, finish)
    return {
        "enc": {"layers": stack(cfg.encoder.n_layers, ("attn",), ("ln1", "ln2")),
                "final_ln": ln(one)},
        "dec": {
            "embed": one.normal("embed", (cfg.vocab, d), d ** -0.5),
            "layers": stack(cfg.n_layers, ("self_attn", "cross_attn"), ("ln1", "ln2", "ln3")),
            "final_ln": ln(one),
            "lm_head": one.normal("lm_head", (d, cfg.vocab), d ** -0.5),
        },
    }


# ---------------------------------------------------------------------------
# Attention pieces
# ---------------------------------------------------------------------------

def _cross_attention(p, x, enc_k, enc_v, cfg):
    """q from the decoder stream x [b, s, d]; k/v [b, kvh, frames, hd]
    precomputed from the encoder output; one non-causal flash launch."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    o = flash_ops.flash_attention(q, enc_k, enc_v, causal=False)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return o @ p["wo"].to(x.dtype)


def _enc_kv(p, enc_out, cfg):
    """The cross-attention's k and v of the encoder output, [b, kvh, frames, hd]."""
    b, f, _ = enc_out.shape
    hd = cfg.head_dim_
    k = enc_out @ p["wk"].to(enc_out.dtype)
    v = enc_out @ p["wv"].to(enc_out.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    k = k.reshape(b, f, cfg.kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, f, cfg.kv_heads, hd).transpose(1, 2)
    return k, v


def _embed_in(dec, tokens, cfg, positions):
    x = layers.embed(dec["embed"], tokens).to(cfg.activation_dtype)
    return x + _sinusoid(positions, cfg.d_model).to(x.dtype)[None]


# ---------------------------------------------------------------------------
# Encoder, teacher-forced decoder, loss
# ---------------------------------------------------------------------------

def encode(params, frames, cfg):
    """frames: [b, F, d] (the stub frontend's output) -> encoder states."""
    x = frames.to(cfg.activation_dtype)
    x = x + _sinusoid(torch.arange(frames.shape[1], device=x.device), cfg.d_model).to(x.dtype)[None]
    enc = params["enc"]
    for i in range(cfg.encoder.n_layers):
        lp = tf_lib.layer_params(enc["layers"], i)
        x = x + attn_lib.attn_forward(lp["attn"], _ln(x, lp["ln1"]), cfg, causal=False)
        x = x + _mlp(_ln(x, lp["ln2"]), lp["mlp"])
    return _ln(x, enc["final_ln"])


def decode_train(params, tokens, enc_out, cfg):
    """Teacher-forced decoder pass over tokens [b, s] -> final hidden states."""
    dec = params["dec"]
    x = _embed_in(dec, tokens, cfg, torch.arange(tokens.shape[1], device=tokens.device))
    for i in range(cfg.n_layers):
        lp = tf_lib.layer_params(dec["layers"], i)
        x = x + attn_lib.attn_forward(lp["self_attn"], _ln(x, lp["ln1"]), cfg, causal=True)
        ek, ev = _enc_kv(lp["cross_attn"], enc_out, cfg)
        x = x + _cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]), ek, ev, cfg)
        x = x + _mlp(_ln(x, lp["ln3"]), lp["mlp"])
    return _ln(x, dec["final_ln"])


def whisper_param_specs(cfg) -> dict:
    """The reference's ``whisper_param_specs`` (``whisper.py:91-110``) as
    tuples: attention and MLP column/row-parallel on the stacked layers,
    the norms, the embedding and lm_head whole (51865 tokens divide no
    model axis)."""
    mx = MODEL_AXIS
    a = {"wq": (None, None, mx), "wk": (None, None, mx), "wv": (None, None, mx),
         "wo": (None, mx, None)}
    if cfg.qkv_bias:
        a.update({"bq": (None, mx), "bk": (None, mx), "bv": (None, mx)})
    mlp = {"w1": (None, None, mx), "b1": (None, mx), "w2": (None, mx, None), "b2": ()}
    ln = {"w": (), "b": ()}
    return {
        "enc": {"layers": {"attn": a, "mlp": mlp, "ln1": ln, "ln2": ln}, "final_ln": ln},
        "dec": {"embed": (None, None),
                "layers": {"self_attn": a, "cross_attn": a, "mlp": mlp, "ln1": ln, "ln2": ln,
                           "ln3": ln},
                "final_ln": ln, "lm_head": (None, None)},
    }


def whisper_loss(params, batch, cfg, policy: ParallelPolicy = LOCAL):
    """Mean token cross-entropy of the teacher-forced decoder on
    ``batch`` {"frames", "tokens", "targets"}; returns (xent, {"xent"}).
    A mesh policy over more than one model rank raises."""
    tf_lib.check_mesh_arch(cfg, policy)
    enc_out = encode(params, batch["frames"], cfg)
    h = decode_train(params, batch["tokens"], enc_out, cfg)
    xent = layers.chunked_cross_entropy(h, params["dec"]["lm_head"], batch["targets"])
    return xent, {"xent": xent}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_whisper_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """The zeroed bf16 cache: the decoder's self-attention k/v [L, batch,
    kvh, max_len, hd] and the cross-attention's k/v [L, batch, kvh,
    frames, hd]."""
    device = resolve_device(device)
    n, kvh, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim_

    def zeros(s):
        return torch.zeros((n, batch, kvh, s, hd), dtype=torch.bfloat16, device=device)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross_k": zeros(cfg.encoder.frames), "cross_v": zeros(cfg.encoder.frames)}


def whisper_prefill(params, tokens, frames, cfg, max_len: Optional[int] = None):
    """Encode the audio and teacher-force the prompt tokens [b, s]; returns
    (last-token logits [b, V] float32, the cache): the prompt's k/v in the
    first s positions of a self cache of ``max_len`` (default s), zeros
    past it, and the encoder's cross k/v, all bf16."""
    b, s = tokens.shape
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit max_len={max_len}")
    enc_out = encode(params, frames, cfg)
    dec = params["dec"]
    positions = torch.arange(s, device=tokens.device)
    x = _embed_in(dec, tokens, cfg, positions)
    cache = init_whisper_cache(cfg, b, max_len, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = tf_lib.layer_params(dec["layers"], i)
        q, k, v = attn_lib._project_qkv(lp["self_attn"], _ln(x, lp["ln1"]), cfg, positions)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        o = flash_attention_ref(q.transpose(1, 2), kt, vt, causal=True)
        x = x + o.transpose(1, 2).reshape(b, s, -1) @ lp["self_attn"]["wo"].to(x.dtype)
        ek, ev = _enc_kv(lp["cross_attn"], enc_out, cfg)
        x = x + _cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]), ek, ev, cfg)
        x = x + _mlp(_ln(x, lp["ln3"]), lp["mlp"])
        cache["self"]["k"][i, :, :, :s] = kt
        cache["self"]["v"][i, :, :, :s] = vt
        cache["cross_k"][i] = ek
        cache["cross_v"][i] = ev
    h = _ln(x, dec["final_ln"])
    return layers.logits_last(h[:, -1], dec["lm_head"]), cache


def whisper_decode_step(params, token, cache, index, cfg):
    """One decoder step for every row: token [b, 1] at position ``index``
    (one int for the batch, the number of tokens already in the self
    cache), against the self cache (written at ``index`` in place) and
    the static cross cache, cast to the activation dtype. Returns (logits
    [b, V] float32, cache)."""
    index = int(index)
    dec = params["dec"]
    b = token.shape[0]
    x = _embed_in(dec, token, cfg, torch.full((1,), index, device=token.device))
    idx = torch.full((b,), index, dtype=torch.long, device=token.device)
    for i in range(cfg.n_layers):
        lp = tf_lib.layer_params(dec["layers"], i)
        sc = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}
        y, _ = attn_lib.attn_decode(lp["self_attn"], _ln(x, lp["ln1"]), sc, idx, cfg,
                                    n_keys=index + 1)
        x = x + y
        ek, ev = cache["cross_k"][i].to(x.dtype), cache["cross_v"][i].to(x.dtype)
        x = x + _cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]), ek, ev, cfg)
        x = x + _mlp(_ln(x, lp["ln3"]), lp["mlp"])
    h = _ln(x, dec["final_ln"])
    return layers.logits_last(h[:, 0], dec["lm_head"]), cache


def flash_per_prefill(cfg) -> int:
    """Flash launches of a prefill: the encoder's layers and each decoder
    layer's cross-attention."""
    return cfg.encoder.n_layers + cfg.n_layers


def flash_per_loss(cfg) -> int:
    """Flash launches of a ``whisper_loss``: the encoder's layers, and each
    decoder layer's self- and cross-attention."""
    return cfg.encoder.n_layers + 2 * cfg.n_layers
