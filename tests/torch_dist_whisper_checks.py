"""What each rank of ``tests/test_torch_dist_whisper.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_checks`` runs on every one of 4 gloo ranks on
the CPU, for two configs (``CONFIGS``): reduced whisper-tiny (4 heads
over 2 kv heads of 16) and a narrow one that keeps whisper-tiny's 6 heads
= 6 kv heads (pad to 8 at P = 4, rank 3 holding padding only, the 96
columns of a projection cut at 24 a rank, inside a head, as the full
width's 384 are cut at 96). Each check takes the numpy inputs the test
drew from the JAX reference's weights:

* ``loss``: ``whisper_loss`` on (1 x 4) and (2 x 2), ``seq_shard`` on and
  off, each rank its rows and shards, the gradients reduced by
  ``reduce_grads``'s LM rule and gathered whole (``gather_params``); the
  data group's mean loss; ``encode``'s output put back together;
* ``cut``: the same with the cross-attention's sum over the group cut
  (``layers.tp_out`` the identity, or this rank's slice, inside its
  ``_attn_tp``), and with the LayerNorms' ``copy_to`` cut (their gradient
  then a rank's part), which the test's gates must refuse;
* ``serve``: ``whisper_prefill`` and greedy ``whisper_decode_step`` on
  (1 x 4) with ``seq_shard``, (2 x 2) and (4 x 1), on ``serving_heads``
  of the rank's shards, f32 caches: each step's logits of every row, the tokens, the
  cache's leaf shapes and bytes, and the rank's cache heads against the
  serial prefill's heads it should hold (padding heads zero); one decode
  step on the unpicked shards against the picked ones.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.common.tree import tree_map
from repro_torch.configs import get_arch, reduced
from repro_torch.core.collectives import scatter_to
from repro_torch.core.partition import gather_dim, local_slice
from repro_torch.launch.mesh import build_lm_groups
from repro_torch.models import ParallelPolicy, whisper_params_from_numpy
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import whisper as wh
from repro_torch.models.transformer import gather_params, param_parts, shard_params
from repro_torch.train.optimizer import state_layout
from repro_torch.train.train_loop import accumulate_grads, reduce_grads, zeros_like_tree

LAYOUTS = {"1x4": 4, "2x2": 2, "4x1": 1}
BATCH, SEQ = 4, 8
PROMPT, STEPS = 4, 5
LOSS_RUNS = tuple((name, layout, sp) for name in ("reduced", "narrow") for layout in ("1x4", "2x2")
                  for sp in (True, False))
# the runs with a sum cut: the cross-attention's reduce, the LayerNorms' copy_to
CUT_RUNS = {"cross": ("narrow", "1x4", False), "layernorm": ("narrow", "1x4", True)}
SERVE_RUNS = tuple((name, layout) for name in ("reduced", "narrow") for layout in LAYOUTS)


def whisper_cfg(name: str):
    """reduced(whisper-tiny) in f32, or the narrow config with its 6
    heads = 6 kv heads of 16."""
    cfg = dataclasses.replace(reduced(get_arch("whisper-tiny")), dtype="float32")
    if name == "narrow":
        cfg = dataclasses.replace(cfg, d_model=96, n_heads=6, kv_heads=6, d_ff=192)
    return cfg


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _loss(groups, inp, name, layout, sp) -> dict:
    cfg = whisper_cfg(name)
    pol = ParallelPolicy(mesh=groups[layout], seq_shard=sp)
    whole = whisper_params_from_numpy(inp[f"params_{name}"], device="cpu")
    local = shard_params(whole, cfg, pol)
    batch = {k: local_slice(_t(inp[f"{name}_{k}"]), 0, pol.data_group)
             for k in ("frames", "tokens", "targets")}
    batch["tokens"], batch["targets"] = batch["tokens"].long(), batch["targets"].long()
    grads = zeros_like_tree(local)
    loss, _ = accumulate_grads(lambda p, b: wh.whisper_loss(p, b, cfg, pol), local, batch, grads)
    layout_ = state_layout(groups[layout], param_parts(cfg, pol, whole),
                           tree_map(lambda p: tuple(p.shape), whole), grads_complete=True)
    reduce_grads(grads, layout_)
    mean = loss.clone()
    torch.distributed.all_reduce(mean, group=pol.data_group)
    with torch.no_grad():
        enc = wh.encode(local, batch["frames"], cfg, pol)
        if wh.enc_sharded(cfg, pol):
            enc = gather_dim(enc.contiguous(), 1, pol.model_group)
        enc = gather_dim(enc.contiguous(), 0, pol.data_group)
    return {"loss": float(mean) / pol.dp_size(), "grads": gather_params(grads, cfg, pol),
            "encode": enc}


@contextlib.contextmanager
def cut_cross_reduce():
    """Within the block the cross-attention's row-parallel output is not
    summed over the group: ``layers.tp_out`` is the identity (this rank's
    slice under ``seq_shard``) inside an ``_attn_tp`` given ``kv_x``."""
    saved = attn_lib._attn_tp

    def cut(*args, kv_x=None, **kw):
        if kv_x is None:
            return saved(*args, **kw)
        tp_out = layers.tp_out
        layers.tp_out = lambda y, group, sp: scatter_to(y, 1, group) if sp else y
        try:
            return saved(*args, kv_x=kv_x, **kw)
        finally:
            layers.tp_out = tp_out

    attn_lib._attn_tp = cut
    try:
        yield
    finally:
        attn_lib._attn_tp = saved


@contextlib.contextmanager
def cut_layernorm_sum():
    """Within the block the LayerNorms on a rank's slice of the sequence
    take w and b without ``copy_to``: their gradient stays a rank's part."""
    saved = wh._ln_of
    wh._ln_of = lambda x, p, policy, sp: wh._ln(x, p)
    try:
        yield
    finally:
        wh._ln_of = saved


def _cut(groups, inp, what) -> dict:
    ctx = cut_cross_reduce() if what == "cross" else cut_layernorm_sum()
    with ctx:
        return _loss(groups, inp, *CUT_RUNS[what])


def _greedy(params, frames, prompt, cfg, pol):
    """The prefill and ``STEPS`` greedy decode steps: logits of every
    step [STEPS + 1, b, V], the tokens, and the cache."""
    logits, cache = wh.whisper_prefill(params, prompt, frames, cfg, max_len=PROMPT + STEPS,
                                       policy=pol, cache_dtype=torch.float32)
    out, tok = [logits], torch.argmax(logits, -1)[:, None]
    toks = [tok]
    for i in range(STEPS):
        logits, cache = wh.whisper_decode_step(params, tok, cache, PROMPT + i, cfg, pol)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(logits)
        toks.append(tok)
    return torch.stack(out), torch.cat(toks, 1), cache


def _serve(groups, inp, name, layout) -> dict:
    cfg = whisper_cfg(name)
    pol = ParallelPolicy(mesh=groups[layout], seq_shard=layout == "1x4")
    whole = whisper_params_from_numpy(inp[f"params_{name}"], device="cpu")
    frames = _t(inp[f"{name}_frames"])
    prompt = _t(inp[f"{name}_tokens"][:, :PROMPT]).long()
    data = pol.data_group
    with torch.no_grad():
        _, _, serial_cache = _greedy(whole, frames, prompt, cfg, wh.LOCAL)
        local = shard_params(whole, cfg, pol)
        served = wh.serving_heads(local, cfg, pol)
        rows = slice(pol.data_rank() * (BATCH // pol.dp_size()),
                     (pol.data_rank() + 1) * (BATCH // pol.dp_size()))
        logits, toks, cache = _greedy(served, frames[rows], prompt[rows], cfg, pol)
        # one step on the unpicked shards (each step gathering the weights)
        first = torch.argmax(logits[0], -1)[:, None]
        _, again = wh.whisper_prefill(local, prompt[rows], frames[rows], cfg,
                                      max_len=PROMPT + STEPS, policy=pol,
                                      cache_dtype=torch.float32)
        unpicked, _ = wh.whisper_decode_step(local, first, again, PROMPT, cfg, pol)
        hs = attn_lib.tp_heads(cfg, pol)
        n_kv = hs.n_kv
        real = hs.kv_heads.numel()
        head_rel, pad_max = 0.0, 0.0
        for name_, got in (("k", cache["self"]["k"]), ("v", cache["self"]["v"]),
                           ("ck", cache["cross_k"]), ("cv", cache["cross_v"])):
            ref = {"k": serial_cache["self"]["k"], "v": serial_cache["self"]["v"],
                   "ck": serial_cache["cross_k"], "cv": serial_cache["cross_v"]}[name_]
            want = ref[:, rows].index_select(2, hs.kv_heads)
            if real:
                head_rel = max(head_rel, float((got[:, :, :real] - want).abs().max())
                               / float(want.abs().max()))
            if n_kv > real:  # padding heads: zeros, never a neighbour's head
                pad_max = max(pad_max, float(got[:, :, real:].abs().max()))
    leaves = [cache["self"]["k"], cache["self"]["v"], cache["cross_k"], cache["cross_v"]]
    return {"logits": gather_dim(logits.contiguous(), 1, data),
            "tokens": gather_dim(toks.contiguous(), 0, data),
            "unpicked_d": float((unpicked - logits[1]).abs().max()),
            "shapes": [tuple(t.shape) for t in leaves],
            "cache_bytes": sum(t.numel() * t.element_size() for t in leaves),
            "n_kv": n_kv, "real_kv": real, "head_rel": head_rel, "pad_max": pad_max}


def run_checks(rank, world_size, device, inp):
    groups = {name: build_lm_groups(world_size, p) for name, p in LAYOUTS.items()}
    out = {"loss": {run: _loss(groups, inp, *run) for run in LOSS_RUNS},
           "cut": {what: _cut(groups, inp, what) for what in CUT_RUNS},
           "serve": {run: _serve(groups, inp, *run) for run in SERVE_RUNS}}
    if rank:  # the others' serving facts; rank 0 returns the gathered outputs
        out = {"serve": {run: {k: v for k, v in r.items() if k not in ("logits", "tokens")}
                         for run, r in out["serve"].items()}}
    return out
