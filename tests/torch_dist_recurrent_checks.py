"""What each rank of ``tests/test_torch_dist_recurrent.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_checks`` runs on every one of 4 gloo ranks on
the CPU; each check takes the numpy inputs the test drew:

* ``lm``: ``lm_loss`` of reduced mamba2-370m (8 SSD heads of 16, d_inner
  128) and reduced recurrentgemma-2b (window 16, 4 layers: a superblock
  and a tail layer) on (1 x 4) and (2 x 2), ``seq_shard`` on and off, each
  rank's gradients reduced by ``reduce_grads`` and gathered by
  ``gather_params`` (``torch_dist_lm_checks._lm``);
* ``cut``: the mamba2 loss with w_B left out of ``ssm.WHOLE_LEAVES`` (its
  gradient stays each rank's part), and with the gated norm's statistic
  summed by ``reduce_from`` (whose backward drops the other ranks'
  cotangents), which the test's gate must refuse;
* ``ring``: ``attn_decode`` of one local-attention layer over the model
  group, several steps across the ring's wrap from per-row indices: the
  ring by sequence (1 kv head on 4 and on 2 ranks) and by kv heads (an
  MHA variant on 4 ranks); each step's output and the final ring;
* ``ssm_decode``: the SSD decode step over the model group (its heads'
  state on each rank, the conv cache whole), each step's output and the
  final state and conv cache;
* ``engine``: ``Engine(policy=)`` over (1 x 4) with ``seq_shard``, (2 x 2)
  and (4 x 1) for both archs, the requests of the test's serial
  ``Engine`` (prompts past the reduced window and one decoding across its
  wrap), f32 caches: each rank's tokens, the logits of the prefills it ran
  and of every decode step of its rows, and its cache's leaf shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.partition import gather_dim, local_slice
from repro_torch.launch.mesh import build_lm_groups
from repro_torch.models import ParallelPolicy, lm_params_from_numpy
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.transformer import shard_params
from repro_torch.serve.engine import Engine, Request
from torch_dist_lm_checks import _lm
from torch_dist_serve_lm_checks import recording

# (data ranks x model ranks) of the 4 ranks -> ranks to a model group
LAYOUTS = {"1x4": 4, "2x2": 2, "4x1": 1}
ARCHS = ("mamba2-370m", "recurrentgemma-2b")
LM_RUNS = tuple((arch, layout, sp) for arch in ARCHS for layout in ("1x4", "2x2")
                for sp in (False, True))
# the runs the gradient gate must refuse: w_B's copy_to cut, the gated
# norm's statistic through reduce_from
CUT_RUNS = {"w_B": ("1x4", False), "statistic": ("2x2", True)}
# the ring decode checks: (layout, kv heads) of reduced recurrentgemma-2b
RING_RUNS = {"1x4 by sequence": ("1x4", 1), "2x2 by sequence": ("2x2", 1),
             "1x4 by heads": ("1x4", 4)}
RING_START = (12, 3, 29)   # each row's index at the first step: before, near and past the wrap
RING_STEPS = 6
SSM_STEPS = 4
ENGINE_RUNS = tuple((arch, layout) for arch in ARCHS for layout in LAYOUTS)
MAX_LEN, SLOTS = 48, 4
# (prompt length, max_tokens): prompts past the reduced window of 16 (20,
# 24), one decoding across its wrap (10 + 12), lengths 4 divides and not
REQUESTS = ((20, 5), (10, 12), (5, 6), (16, 4), (7, 9), (24, 3))


def lm_cfg(arch: str):
    """The reduced config of ``arch``, float32 activations; the hybrid at
    4 layers, so that a tail layer runs."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
    return dataclasses.replace(cfg, n_layers=4) if cfg.family == "hybrid" else cfg


def ring_cfg(kv_heads: int):
    return dataclasses.replace(lm_cfg("recurrentgemma-2b"), kv_heads=kv_heads)


def requests(vocab: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, vocab, size=n).tolist(), max_tokens=m)
            for i, (n, m) in enumerate(REQUESTS)]


def serve(cfg, params, policy, device="cpu") -> dict:
    """The requests through ``Engine`` with f32 caches (every rank alike),
    the logits recorded: {"tokens": {rid: output}, "prefill": {rid:
    logits}, "decode": [logits of this rank's rows], "active": [each
    step's active slots], "flushes", "shapes": [(leaf name, shape) of
    every cache leaf this rank holds]}."""
    engine = Engine(cfg, params, max_len=MAX_LEN, max_batch=SLOTS, device=device, policy=policy,
                    cache_dtype=torch.float32)
    log = {"prefill": {}, "decode": [], "active": [], "admitted": {}}
    for req in requests(cfg.vocab):
        engine.submit(req)
    with recording(engine, log):
        done = engine.run_until_done()
    return {"tokens": {r.rid: list(r.output) for r in done}, "prefill": log["prefill"],
            "decode": log["decode"], "active": log["active"], "flushes": engine.runner.flushes,
            "shapes": [(name, tuple(t.shape)) for name, t in tf_lib._leaves(engine.runner.cache)]}


def _engine(groups, inp, arch, layout) -> dict:
    cfg = lm_cfg(arch)
    pol = ParallelPolicy(mesh=groups[layout], seq_shard=layout == "1x4")
    local = shard_params(lm_params_from_numpy(inp[f"lm_params_{arch}"], device="cpu"), cfg, pol)
    out = serve(cfg, local, pol)
    # every data rank's rows of each step, in slot order
    out["decode"] = [gather_dim(step, 0, pol.data_group) for step in out["decode"]]
    return out


def _cut(groups, inp, what: str) -> dict:
    """``_lm`` of mamba2 on ``CUT_RUNS[what]`` with one of the mixer's two
    sums over the group cut."""
    layout, sp = CUT_RUNS[what]
    saved = ssm_lib.WHOLE_LEAVES, ssm_lib.sum_copies
    if what == "w_B":
        ssm_lib.WHOLE_LEAVES = tuple(n for n in saved[0] if n != "w_B")
    else:
        ssm_lib.sum_copies = ssm_lib.reduce_from
    try:
        return _lm(groups[layout], inp, "mamba2-370m", sp, cfg=lm_cfg("mamba2-370m"))
    finally:
        ssm_lib.WHOLE_LEAVES, ssm_lib.sum_copies = saved


def _ring(groups, inp, name: str) -> dict:
    """The ring's decode steps on this rank's part of the ring and of the
    layer's weights (wq/wk/wv columns, wo rows): outputs [steps, b, 1, d]
    and the final ring, put back together."""
    layout, kvh = RING_RUNS[name]
    cfg = ring_cfg(kvh)
    pol = ParallelPolicy(mesh=groups[layout])
    group = pol.model_group
    by_seq = attn_lib.prefix_by_sequence(cfg, pol)
    whole = {k: torch.from_numpy(v) for k, v in inp[f"ring_params_{kvh}"].items()}
    dims = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    p = {k: local_slice(v, dims[k], group).clone() for k, v in whole.items()}
    cache = {n: local_slice(torch.from_numpy(inp[f"ring_{n}_{kvh}"]), 2 if by_seq else 1,
                            group).clone() for n in ("k", "v")}
    start = torch.tensor(RING_START)
    outs = []
    for t in range(RING_STEPS):
        x = torch.from_numpy(inp["ring_x"][t])
        out, cache = attn_lib.attn_decode(p, x, cache, start + t, cfg, policy=pol)
        outs.append(out)
    return {"out": torch.stack(outs),
            "ring": {n: gather_dim(c, 2 if by_seq else 1, group) for n, c in cache.items()}}


def _ssm_decode(groups, inp, layout: str) -> dict:
    """mamba2's decode steps over the model group of ``layout`` on this
    rank's mixer shards and its heads of the state: outputs [steps, b, 1,
    d], the final state put back together and the conv cache."""
    cfg = lm_cfg("mamba2-370m")
    pol = ParallelPolicy(mesh=groups[layout])
    group = pol.model_group
    specs = tf_lib._layer_specs(cfg, "ssm", "model")["mixer"]
    whole = {k: torch.from_numpy(v) for k, v in inp["ssm_params"].items()}
    p = {k: local_slice(v, specs[k].index("model"), group).clone() if "model" in specs[k] else v
         for k, v in whole.items()}
    cache = {"conv": torch.from_numpy(inp["ssm_conv"]).clone(),
             "state": local_slice(torch.from_numpy(inp["ssm_state"]), 1, group).clone()}
    outs = []
    for t in range(SSM_STEPS):
        out, cache = ssm_lib.ssm_decode(p, torch.from_numpy(inp["ssm_x"][t]), cache, cfg.d_model,
                                        cfg.ssm, group=group)
        outs.append(out)
    return {"out": torch.stack(outs), "state": gather_dim(cache["state"], 1, group),
            "conv": cache["conv"]}


def run_checks(rank, world_size, device, inp):
    groups = {name: build_lm_groups(world_size, p) for name, p in LAYOUTS.items()}
    out = {"lm": {(arch, layout, sp): _lm(groups[layout], inp, arch, sp, cfg=lm_cfg(arch))
                  for arch, layout, sp in LM_RUNS},
           "cut": {what: _cut(groups, inp, what) for what in CUT_RUNS},
           "ring": {name: _ring(groups, inp, name) for name in RING_RUNS},
           "ssm_decode": {layout: _ssm_decode(groups, inp, layout) for layout in ("1x4", "2x2")},
           "engine": {run: _engine(groups, inp, *run) for run in ENGINE_RUNS}}
    if rank:  # the others' shapes, flushes and tokens, and their own prefills
        out = {"engine": out["engine"]}
        for run in out["engine"].values():
            run["decode"] = None
    return out
