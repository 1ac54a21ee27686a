"""Whisper-style encoder-decoder (audio frontend stubbed): parameters, loss, prefill, decode.

Port of ``repro.models.whisper``, serially and under a mesh policy
(``models/policy.py``), with its tensor-parallel specs
(``whisper_param_specs``, as tuples). The conv/mel frontend is a stub:
the inputs are precomputed frame embeddings [b, frames, d_model].
Encoder: bidirectional self-attention + GELU MLP, sinusoidal positions. Decoder: causal
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

Over (data x model) ranks each rank holds its shards
(``transformer.shard_params`` by ``whisper_param_specs``) and its rows,
and every attention runs tensor-parallel over its heads
(``attention._attn_tp``; whisper-tiny's 6 heads zero-padded to 8 at
P = 4, rank 3 holding padding only, whose output adds zero), the
cross-attention's k/v projected from the encoder's output, which enters
the model group once a decoder pass (``_cross_in``). Under ``seq_shard``
the encoder's and the decoder's streams are each rank's slice of their
sequence (1500 frames: 375 a rank at P = 4), the LayerNorms on its rows
(``copy_to`` on w and b, their gradient a part), the loss's parts summed
over the group. The caches hold each rank's rows and heads
(``whisper_cache_specs``). Every rank launches flash as often as the
serial path does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.core.collectives import all_gather, copy_to, reduce_from, scatter_to
from repro_torch.core.partition import local_slice
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import transformer as tf_lib
from repro_torch.models.policy import DATA_AXIS, LOCAL, MODEL_AXIS, ParallelPolicy

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

def _cross_attention(p, x, enc_k, enc_v, cfg, policy: ParallelPolicy = LOCAL):
    """q from the decoder stream x [b, s, d]; k/v [b, kvh, frames, hd]
    precomputed from the encoder output (over a model group this rank's kv
    heads, ``_enc_kv``); one non-causal flash launch. Over a model group
    the rank's q heads attend (``attention.tp_q``) and ``wo``'s rows are
    summed over the group (``attention.tp_heads_out``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    if policy.model_size() > 1:
        hs = attn_lib.tp_heads(cfg, policy, x.device)
        o = flash_ops.flash_attention(attn_lib.tp_q(p, x, cfg, policy, hs), enc_k, enc_v,
                                      causal=False)
        return attn_lib.tp_heads_out(o, p, hs, cfg, policy, x.dtype)
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    o = flash_ops.flash_attention(q, enc_k, enc_v, causal=False)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return o @ p["wo"].to(x.dtype)


def _enc_kv(p, enc_out, cfg, policy: ParallelPolicy = LOCAL):
    """The cross-attention's k and v of the encoder output, [b, kvh,
    frames, hd]; over a model group those of this rank's kv heads, padded
    (``attention.tp_heads``), from the whole output on every rank."""
    b, f, _ = enc_out.shape
    hd = cfg.head_dim_
    if policy.model_size() > 1:
        hs = attn_lib.tp_heads(cfg, policy, enc_out.device)
        group = policy.model_group
        bias = cfg.qkv_bias
        kv = [attn_lib._project(enc_out, p["w" + c], p["b" + c] if bias else None, hs.kv_heads,
                                hd, hs.kv_aligned, group) for c in "kv"]
        pad = hs.n_kv - hs.kv_heads.numel()
        return tuple(F.pad(t, (0, 0, 0, pad)).transpose(1, 2) for t in kv)
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


def _sp_in(x, policy: ParallelPolicy, sp: bool):
    """The whole sequence's stream -> this rank's slice of it under
    ``seq_shard`` (the backward all-gathers: every rank then holds the
    whole cotangent, that of the embedding's or frames' whole lookup)."""
    return scatter_to(x, 1, policy.model_group) if sp else x


def _mlp_of(h, p, policy: ParallelPolicy, sp: bool):
    if policy.model_size() > 1:
        return layers.tp_mlp(h, p, "gelu", policy.model_group, sp)
    return _mlp(h, p)


def _ln_of(x, p, policy: ParallelPolicy, sp: bool):
    """A LayerNorm on the stream as the block holds it: on this rank's
    slice of the sequence under ``seq_shard``, where w's and b's gradient
    here is a part, summed over the group by ``copy_to``'s backward."""
    if sp:
        group = policy.model_group
        p = {"w": copy_to(p["w"], group), "b": copy_to(p["b"], group)}
    return _ln(x, p)


# ---------------------------------------------------------------------------
# Encoder, teacher-forced decoder, loss
# ---------------------------------------------------------------------------

def encode(params, frames, cfg, policy: ParallelPolicy = LOCAL):
    """frames: [b, F, d] (the stub frontend's output) -> encoder states.

    Under a mesh policy ``params`` are this rank's shards and ``frames``
    its rows; the self-attention runs tensor-parallel (``_attn_tp``,
    non-causal) and the MLP too; under ``policy.seq_sharded(F)`` the
    states returned are this rank's slice of the frames (``enc_sharded``)."""
    tf_lib.check_mesh_arch(cfg, policy)
    sp = policy.model_size() > 1 and policy.seq_sharded(frames.shape[1])
    x = frames.to(cfg.activation_dtype)
    x = x + _sinusoid(torch.arange(frames.shape[1], device=x.device), cfg.d_model).to(x.dtype)[None]
    x = _sp_in(x, policy, sp)
    enc = params["enc"]
    for i in range(cfg.encoder.n_layers):
        lp = tf_lib.layer_params(enc["layers"], i)
        x = x + attn_lib.attn_forward(lp["attn"], _ln_of(x, lp["ln1"], policy, sp), cfg, policy,
                                      causal=False, seq_sharded=sp)
        x = x + _mlp_of(_ln_of(x, lp["ln2"], policy, sp), lp["mlp"], policy, sp)
    return _ln_of(x, enc["final_ln"], policy, sp)


def enc_sharded(cfg, policy: ParallelPolicy, frames: Optional[int] = None) -> bool:
    """Whether ``encode`` under ``policy`` returns this rank's slice of
    the ``frames`` (default the config's) rather than all of them."""
    return policy.model_size() > 1 and policy.seq_sharded(frames or cfg.encoder.frames)


def _cross_in(enc_out, policy: ParallelPolicy, sharded: bool):
    """The encoder's output entering the model group once for a decoder
    pass, whole on every rank, each rank then projecting its heads' k/v
    from it: the all-gather of a sequence-sharded output (its backward
    reduce-scatters) or ``copy_to`` (its backward all-reduces)."""
    if policy.model_size() == 1:
        return enc_out
    group = policy.model_group
    return all_gather(enc_out, 1, group) if sharded else copy_to(enc_out, group)


def decode_train(params, tokens, enc_out, cfg, policy: ParallelPolicy = LOCAL, *,
                 enc_is_sharded: Optional[bool] = None):
    """Teacher-forced decoder pass over tokens [b, s] -> final hidden states.

    Under a mesh policy ``params`` are this rank's shards, ``tokens`` its
    rows and ``enc_out`` the encoder's output as ``encode`` returns it
    (``enc_is_sharded``, default ``enc_sharded(cfg, policy)``): gathered
    once for the pass (``_cross_in``). Self- and cross-attention run
    tensor-parallel (``_attn_tp``, the cross-attention's k/v from the
    encoder's output), the MLP too; the hidden states are this rank's
    slice of the sequence under ``policy.seq_sharded(s)``."""
    tf_lib.check_mesh_arch(cfg, policy)
    dec = params["dec"]
    s = tokens.shape[1]
    tp = policy.model_size() > 1
    sp = tp and policy.seq_sharded(s)
    if enc_is_sharded is None:
        enc_is_sharded = enc_sharded(cfg, policy)
    kv_in = _cross_in(enc_out, policy, enc_is_sharded)
    x = _sp_in(_embed_in(dec, tokens, cfg, torch.arange(s, device=tokens.device)), policy, sp)
    for i in range(cfg.n_layers):
        lp = tf_lib.layer_params(dec["layers"], i)
        x = x + attn_lib.attn_forward(lp["self_attn"], _ln_of(x, lp["ln1"], policy, sp), cfg,
                                      policy, causal=True, seq_sharded=sp)
        h = _ln_of(x, lp["ln2"], policy, sp)
        if tp:
            x = x + attn_lib._attn_tp(lp["cross_attn"], h, cfg, policy, False, sp, kv_x=kv_in)
        else:
            ek, ev = _enc_kv(lp["cross_attn"], kv_in, cfg)
            x = x + _cross_attention(lp["cross_attn"], h, ek, ev, cfg)
        x = x + _mlp_of(_ln_of(x, lp["ln3"], policy, sp), lp["mlp"], policy, sp)
    return _ln_of(x, dec["final_ln"], policy, sp)


def whisper_param_specs(cfg) -> dict:
    """The reference's ``whisper_param_specs`` (``whisper.py:91-110``) as
    tuples, the layout a rank holds under a mesh policy
    (``transformer.shard_params``): attention wq/wk/wv (bq/bk/bv) column-
    and wo row-parallel on the stacked layers, the MLP's w1/b1 column- and
    w2 row-parallel, b2, the LayerNorms, the embedding and lm_head whole
    (51865 tokens divide no model axis)."""
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

    Under a mesh policy ``params`` are this rank's shards and ``batch``
    its rows, and every rank of a model group returns the loss of its data
    rank's rows: lm_head whole on each rank's hidden states (the
    reference shards the logits by vocab, which 51865 does not divide;
    the sum is the same), under ``seq_shard`` on its slice of the
    sequence, the parts summed over the group (lm_head through
    ``copy_to``, its gradient a part there)."""
    frames, tokens, targets = batch["frames"], batch["tokens"], batch["targets"]
    enc_out = encode(params, frames, cfg, policy)
    h = decode_train(params, tokens, enc_out, cfg, policy,
                     enc_is_sharded=enc_sharded(cfg, policy, frames.shape[1]))
    lm_head = params["dec"]["lm_head"]
    s = targets.shape[1]
    if policy.model_size() > 1 and policy.seq_sharded(s):
        group = policy.model_group
        part = layers.chunked_cross_entropy(h, copy_to(lm_head, group),
                                            local_slice(targets, 1, group))
        xent = reduce_from(part * (h.shape[1] / s), group)
    else:
        xent = layers.chunked_cross_entropy(h, lm_head, targets)
    return xent, {"xent": xent}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def whisper_cache_specs(cfg, policy: ParallelPolicy) -> dict:
    """The cache's layout over the mesh, a spec as the tuple of its
    entries, whose part on a rank ``init_whisper_cache`` allocates: the
    rows over the data axis; the self cache and the cross cache over the
    model axis by this rank's kv heads as its attention takes them
    (``cache_heads``: padded with zero heads where P does not divide the
    heads, so that every rank's part has one shape; a GQA rank's heads'
    runs).

    The reference keeps both caches whole over the model ranks
    (``src/repro/launch/dryrun.py:145-150``), which would need an
    all-gather of every layer's k/v in each decode step; here each rank
    reads only its own heads."""
    mx, dp = MODEL_AXIS, DATA_AXIS
    leaf = (None, dp, mx, None, None)
    return {"self": {"k": leaf, "v": leaf}, "cross_k": leaf, "cross_v": leaf}


def cache_heads(cfg, policy: ParallelPolicy) -> int:
    """The kv heads a rank's cache holds: all of them, or over a model
    group the rank's as its attention takes them, padding included."""
    if policy.model_size() == 1:
        return cfg.kv_heads
    return attn_lib.tp_heads(cfg, policy).n_kv


def init_whisper_cache(cfg, batch: int, max_len: int, device=None,
                       policy: ParallelPolicy = LOCAL, dtype=torch.bfloat16) -> dict:
    """The zeroed cache, bf16 as the reference's unless ``dtype`` says
    otherwise: the decoder's self-attention k/v [L, batch, kvh, max_len,
    hd] and the cross-attention's k/v [L, batch, kvh, frames, hd]. Under
    a mesh policy this rank's part
    (``whisper_cache_specs``): its data rank's batch/D rows and its
    ``cache_heads`` kv heads."""
    tf_lib.check_mesh_arch(cfg, policy)
    device = resolve_device(device)
    d = policy.dp_size()
    if batch % d:
        raise ValueError(f"{batch} cache rows do not split over {d} data ranks")
    return _zeroed_cache(cfg, batch // d, max_len, device, cache_heads(cfg, policy), dtype)


def _zeroed_cache(cfg, rows: int, max_len: int, device, kvh: int, dtype) -> dict:
    n, hd = cfg.n_layers, cfg.head_dim_

    def zeros(s):
        return torch.zeros((n, rows, kvh, s, hd), dtype=dtype, device=device)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross_k": zeros(cfg.encoder.frames), "cross_v": zeros(cfg.encoder.frames)}


def serving_heads(params, cfg, policy: ParallelPolicy) -> dict:
    """This rank's shards with every attention block cut to its heads once
    (``attention.pick_heads``: an all-gather a leaf where the shards are
    not the heads' columns), so that a decode step gathers no weight; the
    identity without a model group."""
    if policy.model_size() == 1:
        return params

    def stack(layers_tree, names):
        return dict(layers_tree, **{n: attn_lib.pick_heads(layers_tree[n], cfg, policy)
                                    for n in names})

    return {"enc": dict(params["enc"], layers=stack(params["enc"]["layers"], ("attn",))),
            "dec": dict(params["dec"], layers=stack(params["dec"]["layers"],
                                                    ("self_attn", "cross_attn")))}


def _plain_attention(q, k, v, causal):
    return flash_attention_ref(q, k, v, causal=causal)


def whisper_prefill(params, tokens, frames, cfg, max_len: Optional[int] = None,
                    policy: ParallelPolicy = LOCAL, cache_dtype=torch.bfloat16):
    """Encode the audio and teacher-force the prompt tokens [b, s]; returns
    (last-token logits [b, V] float32, the cache): the prompt's k/v in the
    first s positions of a self cache of ``max_len`` (default s), zeros
    past it, and the encoder's cross k/v, all bf16 as the reference's
    (``cache_dtype`` another: a float32 cache keeps an f32 run's gate
    free of bf16 rounding flips, as ``Engine(cache_dtype=)``).

    Under a mesh policy ``params`` are this rank's shards (or
    ``serving_heads`` of them), ``tokens`` and ``frames`` its rows; the
    encoder runs as in ``encode`` (its output gathered once under
    ``seq_shard``), the decoder tensor-parallel by heads over the whole
    prompt (never sequence-sharded), each rank writing its heads' k/v
    into its part of the cache (``init_whisper_cache``); every rank
    returns the whole logits."""
    b, s = tokens.shape
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit max_len={max_len}")
    tp = policy.model_size() > 1
    enc_out = encode(params, frames, cfg, policy)
    dec = params["dec"]
    positions = torch.arange(s, device=tokens.device)
    x = _embed_in(dec, tokens, cfg, positions)
    cache = _zeroed_cache(cfg, b, max_len, tokens.device, cache_heads(cfg, policy), cache_dtype)
    if tp:
        kv_in = _cross_in(enc_out, policy, enc_sharded(cfg, policy, frames.shape[1]))
    for i in range(cfg.n_layers):
        lp = tf_lib.layer_params(dec["layers"], i)
        h = _ln(x, lp["ln1"])
        if tp:
            y, _, k, v = attn_lib._attn_tp(lp["self_attn"], h, cfg, policy, True, False,
                                           with_kv=True, attend_fn=_plain_attention)
            x = x + y
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            ek, ev = _enc_kv(lp["cross_attn"], kv_in, cfg, policy)
        else:
            q, k, v = attn_lib._project_qkv(lp["self_attn"], h, cfg, positions)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            o = flash_attention_ref(q.transpose(1, 2), kt, vt, causal=True)
            x = x + o.transpose(1, 2).reshape(b, s, -1) @ lp["self_attn"]["wo"].to(x.dtype)
            ek, ev = _enc_kv(lp["cross_attn"], enc_out, cfg)
        x = x + _cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]), ek, ev, cfg, policy)
        x = x + _mlp_of(_ln(x, lp["ln3"]), lp["mlp"], policy, False)
        cache["self"]["k"][i, :, :, :s] = kt
        cache["self"]["v"][i, :, :, :s] = vt
        cache["cross_k"][i] = ek
        cache["cross_v"][i] = ev
    h = _ln(x, dec["final_ln"])
    return layers.logits_last(h[:, -1], dec["lm_head"]), cache


def whisper_decode_step(params, token, cache, index, cfg, policy: ParallelPolicy = LOCAL):
    """One decoder step for every row: token [b, 1] at position ``index``
    (one int for the batch, the number of tokens already in the self
    cache), against the self cache (written at ``index`` in place) and
    the static cross cache, cast to the activation dtype. Returns (logits
    [b, V] float32, cache).

    Under a mesh policy ``params`` are this rank's shards (best
    ``serving_heads`` of them: else each step gathers the attention
    weights that P does not cut at a head's edge), ``token`` its rows and
    ``cache`` its part: the self-attention is ``attn_decode`` on the
    rank's heads of the self cache, the cross-attention flash on one query
    row over its heads of the cross cache, the MLP tensor-parallel; one
    reduce over the group after each of the three."""
    index = int(index)
    dec = params["dec"]
    b = token.shape[0]
    x = _embed_in(dec, token, cfg, torch.full((1,), index, device=token.device))
    idx = torch.full((b,), index, dtype=torch.long, device=token.device)
    for i in range(cfg.n_layers):
        lp = tf_lib.layer_params(dec["layers"], i)
        sc = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}
        y, _ = attn_lib.attn_decode(lp["self_attn"], _ln(x, lp["ln1"]), sc, idx, cfg,
                                    n_keys=index + 1, policy=policy)
        x = x + y
        ek, ev = cache["cross_k"][i].to(x.dtype), cache["cross_v"][i].to(x.dtype)
        x = x + _cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]), ek, ev, cfg, policy)
        x = x + _mlp_of(_ln(x, lp["ln3"]), lp["mlp"], policy, False)
    h = _ln(x, dec["final_ln"])
    return layers.logits_last(h[:, 0], dec["lm_head"]), cache


def flash_per_prefill(cfg) -> int:
    """Flash launches of a prefill: the encoder's layers and each decoder
    layer's cross-attention (on every rank of a model group alike)."""
    return cfg.encoder.n_layers + cfg.n_layers


def flash_per_loss(cfg) -> int:
    """Flash launches of a ``whisper_loss``: the encoder's layers, and each
    decoder layer's self- and cross-attention (on every rank alike)."""
    return cfg.encoder.n_layers + 2 * cfg.n_layers
