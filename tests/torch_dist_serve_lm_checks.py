"""What each rank of ``tests/test_torch_dist_serve_lm.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_checks`` runs on every one of 4 gloo ranks on
the CPU; each check takes the numpy inputs the test drew:

* ``engine``: ``Engine(policy=)`` over (1 x 4) with ``seq_shard``, (2 x 2)
  and (4 x 1) for a
  GQA config (reduced chatglm3-6b: its 2 kv heads shard by sequence on 4
  model ranks, by heads on 2), an MHA one (reduced gemma-7b with 4 kv
  heads: by heads), an MoE one (reduced deepseek-moe-16b) and an MLA one
  (reduced deepseek-v2-lite-16b: its latent prefix by sequence), and for
  the GQA config with ``kv_quant`` too; each run serves the same requests as
  the test's serial ``Engine``, one of them through a tail flush. Each
  rank returns its requests' tokens, the logits of the prefills it ran and
  of every decode step of its rows, its flushes and its cache's leaf
  shapes, and under MLA the final latent prefixes of every rank put
  together (each rank's chunk of the positions, its data rank's rows);
* ``moe``: ``moe_apply`` over the model group where the all-to-all's
  condition fails: a sequence that P does not divide on (2 x 2) and
  (1 x 4), y, aux and every gradient, and a dropless decode batch.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.partition import gather_dim, local_slice
from repro_torch.launch.mesh import build_lm_groups
from repro_torch.models import ParallelPolicy, lm_params_from_numpy
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.transformer import shard_params
from repro_torch.serve.engine import Engine, Request

# (data ranks x model ranks) of the 4 ranks -> ranks to a model group
LAYOUTS = {"1x4": 4, "2x2": 2, "4x1": 1}
ARCHS = ("gqa", "mha", "moe", "mla")
# (arch, layout, kv_quant, cache dtype) of the Engine runs: every arch on
# every layout with float32 caches (greedy tokens held), int8 prefixes, and
# the reference's bfloat16 caches
ENGINE_RUNS = (tuple((a, lay, False, "float32") for a in ARCHS for lay in LAYOUTS)
               + (("gqa", "1x4", True, "float32"), ("gqa", "2x2", True, "float32"))
               + tuple((a, lay, False, "bfloat16") for a, lay in
                       (("gqa", "1x4"), ("mha", "2x2"), ("moe", "1x4"))))
MAX_LEN, SLOTS = 96, 4
# (prompt length, max_tokens): one request decodes past TAIL_LEN (a flush),
# prompt lengths that 4 and 2 divide and that they do not (the MoE's two paths)
REQUESTS = ((5, 70), (12, 6), (7, 8), (16, 5), (9, 7), (30, 6))
# (data ranks x model ranks, batch, sequence) of the MoE checks: sequences
# that the model group does not divide (past 128 tokens, where the capacity
# drops), and dropless decode batches
MOE_RUNS = {"2x2 s=257": ("2x2", 4, 257), "1x4 s=258": ("1x4", 2, 258),
            "1x4 decode": ("1x4", 8, 1), "2x2 decode": ("2x2", 8, 1)}


def arch_cfg(arch: str):
    """The reduced config of ``arch``, float32 activations."""
    name = {"gqa": "chatglm3-6b", "mha": "gemma-7b", "moe": "deepseek-moe-16b",
            "mla": "deepseek-v2-lite-16b"}[arch]
    cfg = dataclasses.replace(reduced(get_arch(name)), dtype="float32")
    return dataclasses.replace(cfg, kv_heads=cfg.n_heads) if arch == "mha" else cfg


def requests(vocab: int, seed: int = 5) -> list:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, vocab, size=n).tolist(), max_tokens=m)
            for i, (n, m) in enumerate(REQUESTS)]


@contextlib.contextmanager
def recording(engine, log: dict):
    """Within the block the runner's prefills log (rid, logits), its
    admissions the request each slot took last, its decode steps the
    logits of this rank's rows and the active slots."""
    runner = engine.runner
    prefill, decode = tf_lib.lm_prefill, tf_lib.lm_decode_step
    admit, step = runner.admit, runner.step
    current = {}

    def admitted(slot, req):
        current["rid"] = log["admitted"][slot] = req.rid
        return admit(slot, req)

    def stepped(slots, active):
        log["active"].append(list(active))
        return step(slots, active)

    def prefilled(*args, **kw):
        out = prefill(*args, **kw)
        log["prefill"][current["rid"]] = out[0][0].clone()
        return out

    def decoded(*args, **kw):
        out = decode(*args, **kw)
        log["decode"].append(out[0].clone())
        return out

    runner.admit, runner.step = admitted, stepped
    tf_lib.lm_prefill, tf_lib.lm_decode_step = prefilled, decoded
    try:
        yield
    finally:
        tf_lib.lm_prefill, tf_lib.lm_decode_step = prefill, decode
        del runner.admit, runner.step


def serve(cfg, params, policy, cache_dtype: str, device="cpu") -> dict:
    """The requests through ``Engine`` (every rank alike), with the logits
    recorded: {"tokens": {rid: output}, "prefill": {rid: logits},
    "decode": [logits of this rank's rows], "active": [each step's active
    slots], "admitted": {slot: rid of its last request}, "flushes",
    "shapes" (of the stacked layers' cache leaves), "latents" (MLA: the
    final ckv and kr of every layer, [L, rows, S, ...], as this rank holds
    them)}."""
    engine = Engine(cfg, params, max_len=MAX_LEN, max_batch=SLOTS, device=device, policy=policy,
                    cache_dtype=getattr(torch, cache_dtype))
    log = {"prefill": {}, "decode": [], "active": [], "admitted": {}}
    for req in requests(cfg.vocab):
        engine.submit(req)
    with recording(engine, log):
        done = engine.run_until_done()
    cache = engine.runner.cache
    shapes = {name: tuple(t.shape) for name, t in cache["layers"].items()}
    latents = None
    if cfg.mla is not None:
        first = [] if cache["layer0"] is None else [cache["layer0"]]
        latents = {name: torch.cat([c[name][None] for c in first] + [cache["layers"][name]])
                   for name in ("ckv", "kr")}
    return {"tokens": {r.rid: list(r.output) for r in done}, "prefill": log["prefill"],
            "decode": log["decode"], "active": log["active"], "admitted": log["admitted"],
            "flushes": engine.runner.flushes, "shapes": shapes, "latents": latents}


def _engine(groups, inp, arch, layout, quant, cache_dtype) -> dict:
    cfg = arch_cfg(arch)
    pol = ParallelPolicy(mesh=groups[layout], kv_quant=quant, seq_shard=layout == "1x4")
    local = shard_params(lm_params_from_numpy(inp["params"][arch], device="cpu"), cfg, pol)
    out = serve(cfg, local, pol, cache_dtype)
    # every data rank's rows of each step, in slot order
    out["decode"] = [gather_dim(step, 0, pol.data_group) if pol.dp_size() > 1 else step
                     for step in out["decode"]]
    if out["latents"] is not None:  # the chunks of positions, then the data ranks' rows
        out["latents"] = {name: gather_dim(gather_dim(t, 2, pol.model_group), 1, pol.data_group)
                          for name, t in out["latents"].items()}
    return out


def _moe(groups, inp, name) -> dict:
    layout, _, s = MOE_RUNS[name]
    moe = moe_lib.MoEConfig(**inp["moe_cfg"])
    pol = ParallelPolicy(mesh=groups[layout])
    whole = lm_params_from_numpy(inp["moe_params"], device="cpu")
    specs = {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0}
    shared = {"w_gate": 1, "w_up": 1, "w_down": 0}

    def cut(t, dim):
        if dim is None or pol.model_size() == 1:
            return t.clone().requires_grad_()
        return local_slice(t, dim, pol.model_group).clone().requires_grad_()

    local = {k: cut(whole[k], specs[k]) for k in specs}
    local["shared"] = {k: cut(whole["shared"][k], shared[k]) for k in shared}
    x = local_slice(torch.from_numpy(inp[f"moe_x {name}"]), 0, pol.data_group)
    x = x.clone().requires_grad_()
    decode = s == 1
    y, aux = moe_lib.moe_apply(local, x, moe, pol, dropless=decode)
    out = {"y": gather_dim(y.detach(), 0, pol.data_group), "aux": aux.detach()}
    if decode:
        return out
    cot = local_slice(torch.from_numpy(inp[f"moe_cot {name}"]), 0, pol.data_group)
    flat = {**{k: local[k] for k in specs},
            **{f"shared.{k}": v for k, v in local["shared"].items()}, "x": x}
    loss = (y * cot).sum() + aux / pol.dp_size()
    got = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    dims = {**specs, **{f"shared.{k}": v for k, v in shared.items()}}
    grads = {}
    for k, g in got.items():
        if k == "x":
            grads[k] = gather_dim(g, 0, pol.data_group)
            continue
        g = g.clone()
        torch.distributed.all_reduce(g, group=pol.data_group)
        if dims[k] is not None and pol.model_size() > 1:
            g = gather_dim(g.contiguous(), dims[k], pol.model_group)
        grads[k] = g
    out["grads"] = grads
    return out


def moe_on_model_ranks(rank, world_size, device, inp):
    """``moe_apply`` of ``inp["x"]`` (whole on every rank) with the experts
    and the shared experts split over ``world_size`` model ranks; rank 0
    returns (y, aux)."""
    pol = ParallelPolicy(mesh=build_lm_groups(world_size, world_size))
    whole = lm_params_from_numpy(inp["params"], device="cpu")
    local = {k: local_slice(whole[k], 0, pol.model_group) if k != "router" else whole[k]
             for k in ("router", "w_gate", "w_up", "w_down")}
    local["shared"] = {k: local_slice(whole["shared"][k], int(k != "w_down"), pol.model_group)
                       for k in ("w_gate", "w_up", "w_down")}
    y, aux = moe_lib.moe_apply(local, torch.from_numpy(inp["x"]), moe_lib.MoEConfig(**inp["cfg"]),
                               pol)
    return (y, aux) if rank == 0 else None


def run_checks(rank, world_size, device, inp):
    groups = {name: build_lm_groups(world_size, p) for name, p in LAYOUTS.items()}
    out = {"engine": {run: _engine(groups, inp, *run) for run in ENGINE_RUNS},
           "moe": {name: _moe(groups, inp, name) for name in MOE_RUNS}}
    if rank:  # the others' shapes and flushes, and their own prefills
        out["moe"] = None
        for run in out["engine"].values():
            run["decode"] = run["latents"] = None
    return out
