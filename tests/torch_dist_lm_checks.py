"""What each rank of ``tests/test_torch_dist_lm.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_checks`` runs on every one of 4 gloo ranks on
the CPU. Each check takes numpy inputs the test drew (and the JAX side
computes its reference from), runs the port's distributed path on this
rank's shards, and rank 0 returns the gathered global outputs and
gradients:

* ``ulysses``: ``ulysses_attention`` over 4 ranks, MHA and the GQA branch
  (kv heads that 4 does not divide), output and d(q, k, v);
* ``head_padding``: ``attn_forward`` of reduced qwen1.5-32b on (1 x 4)
  with 6 heads, and with 2 kv heads at 6 and 10 heads (the ranks whose
  heads are padded take one kv head per q head), output and every
  gradient;
* ``moe``: ``moe_apply`` through the all-to-all on (2 x 2), and the data
  ranks' tokens routed together on (4 x 1), output, aux and every gradient;
* ``lm``: ``lm_loss`` of reduced chatglm3-6b, deepseek-moe-16b and
  deepseek-v2-lite-16b (MLA) on (1 x 4) and (2 x 2), ``seq_shard`` on and
  off, each rank's gradients reduced by ``reduce_grads`` and gathered by
  ``gather_params``; one AdamW step with ZeRO-1 on (2 x 2);
* ``lm_cut``: the MLA loss on (1 x 4) with ``w_dkv``'s ``copy_to`` cut, so
  that its gradient stays each rank's part (which the test's gate must
  refuse);
* ``roundtrip``: ``shard_params`` then ``gather_params`` of every reduced
  decoder config, bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.tree import tree_map
from repro_torch.configs import get_arch, reduced
from repro_torch.core.partition import gather_dim, local_slice
from repro_torch.core.ulysses import ulysses_attention
from repro_torch.launch.mesh import build_lm_groups
from repro_torch.models import ParallelPolicy, lm_loss, lm_params_from_numpy
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import gather_params, param_parts, shard_params
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, state_layout
from repro_torch.train.train_loop import (
    accumulate_grads, make_train_step, reduce_grads, zeros_like_tree,
)

# (data ranks x model ranks) of the 4 ranks -> ranks to a model group
LAYOUTS = {"1x4": 4, "2x2": 2, "4x1": 1}
LM_ARCHS = ("chatglm3-6b", "deepseek-moe-16b", "deepseek-v2-lite-16b")
LM_RUNS = tuple((arch, layout, sp) for arch in LM_ARCHS for layout in ("1x4", "2x2")
                for sp in (False, True))
STEP_RUN = ("chatglm3-6b", "2x2", True)
CUT_RUN = ("deepseek-v2-lite-16b", "1x4", False)
# (q heads, kv heads) of the head-padding checks on 4 ranks
HEAD_PADDING = {"mha": (6, 6), "6q-2kv": (6, 2), "10q-2kv": (10, 2)}
OPT_KW = dict(lr=1e-3, grad_clip=0.5)


def lm_cfg(arch: str):
    return dataclasses.replace(reduced(get_arch(arch)), dtype="float32")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rows(x, group):
    """This data rank's rows of a batch-first tensor."""
    return local_slice(x, 0, group)


def _whole(x, dim, group):
    return gather_dim(x.contiguous(), dim, group)


def _grads_of(params, out, cot):
    """d sum(out * cot) / d params (a dict or a list of tensors)."""
    leaves = list(params.values()) if isinstance(params, dict) else list(params)
    got = torch.autograd.grad((out * cot).sum(), leaves, allow_unused=True)
    return (dict(zip(params, got)) if isinstance(params, dict) else list(got))


def _ulysses(group, inp) -> dict:
    out = {}
    for name in ("mha", "gqa"):
        q, k, v, cot = (_t(inp[f"{name}_{n}"]) for n in ("q", "k", "v", "cot"))
        local = [local_slice(t, 1, group).clone().requires_grad_() for t in (q, k, v)]
        o = ulysses_attention(*local, group, causal=True)
        grads = _grads_of(local, o, local_slice(cot, 1, group))
        out[name] = {"out": _whole(o.detach(), 1, group),
                     "grads": [_whole(g, 1, group) for g in grads]}
    return out


def _head_padding(groups, inp, name: str) -> dict:
    h, kvh = HEAD_PADDING[name]
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-32b")), n_heads=h, kv_heads=kvh,
                              dtype="float32")
    pol = ParallelPolicy(mesh=groups, seq_shard=False)
    whole = lm_params_from_numpy(inp["attn"][name], device="cpu")
    # the reference's specs for one (unstacked) attention layer
    specs = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}
    local = {k: local_slice(v, specs[k], pol.model_group).clone().requires_grad_()
             for k, v in whole.items()}
    x = _rows(_t(inp["x"]), pol.data_group).clone().requires_grad_()
    o = attn_lib.attn_forward(local, x, cfg, pol)
    g = _grads_of({**local, "x": x}, o, _rows(_t(inp["cot"]), pol.data_group))
    grads = {k: _whole(g[k], specs[k], pol.model_group) for k in local}
    # the data group's rows: each data rank's parameter gradient is its rows' part
    grads["x"] = _whole(g["x"], 0, pol.data_group)
    return {"out": _whole(o.detach(), 0, pol.data_group), "grads": grads}


def _moe(groups, inp, cf: str, layout: str) -> dict:
    moe = moe_lib.MoEConfig(**inp[f"moe_cfg_{cf}"])
    pol = ParallelPolicy(mesh=groups)
    whole = lm_params_from_numpy(inp[f"moe_params_{cf}"], device="cpu")
    specs = {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0}
    shared = {"w_gate": 1, "w_up": 1, "w_down": 0}

    def cut(t, dim):
        if dim is None or pol.model_size() == 1:
            return t.clone().requires_grad_()
        return local_slice(t, dim, pol.model_group).clone().requires_grad_()

    local = {k: cut(whole[k], specs[k]) for k in specs}
    local["shared"] = {k: cut(whole["shared"][k], shared[k]) for k in shared}
    x = _rows(_t(inp[f"moe_x_{cf}"]), pol.data_group).clone().requires_grad_()
    y, aux = moe_lib.moe_apply(local, x, moe, pol)
    cot = _rows(_t(inp[f"moe_cot_{cf}"]), pol.data_group)
    flat = {**{k: local[k] for k in specs}, **{f"shared.{k}": v for k, v in local["shared"].items()},
            "x": x}
    leaves = list(flat.values())
    # each data rank's term: its rows' sum(y * cot) plus aux, the global
    # objective the data ranks' terms sum to (the reference's one call)
    loss = (y * cot).sum() + aux / pol.dp_size()
    got = dict(zip(flat, torch.autograd.grad(loss, leaves)))
    dims = {**specs, **{f"shared.{k}": v for k, v in shared.items()}}
    grads = {}
    for k, g in got.items():
        if k == "x":
            grads[k] = _whole(g, 0, pol.data_group)
            continue
        g = g.clone()
        torch.distributed.all_reduce(g, group=pol.data_group)
        if dims[k] is not None and pol.model_size() > 1:
            g = _whole(g, dims[k], pol.model_group)
        grads[k] = g
    return {"y": _whole(y.detach(), 0, pol.data_group), "aux": aux.detach(), "grads": grads,
            "layout": layout}


def _lm(groups, inp, arch: str, sp: bool, cfg=None) -> dict:
    """``lm_loss`` of ``arch`` (``cfg``, or its reduced f32 config) on this
    rank's rows and shards: the data group's mean [loss, xent, aux] and
    the gradients reduced by ``reduce_grads`` and gathered whole."""
    cfg = cfg or lm_cfg(arch)
    pol = ParallelPolicy(mesh=groups, seq_shard=sp)
    whole = lm_params_from_numpy(inp[f"lm_params_{arch}"], device="cpu")
    local = shard_params(whole, cfg, pol)
    batch = {k: _rows(_t(inp[f"lm_{k}"]).long(), pol.data_group) for k in ("tokens", "targets")}
    grads = zeros_like_tree(local)
    loss, metrics = accumulate_grads(lambda p, b: lm_loss(p, b, cfg, pol), local, batch, grads)
    shapes = tree_map(lambda p: tuple(p.shape), whole)
    layout = state_layout(groups, param_parts(cfg, pol, whole), shapes, grads_complete=True)
    reduce_grads(grads, layout)
    mean = torch.stack([loss, metrics["xent"], metrics["aux"]])
    torch.distributed.all_reduce(mean, group=pol.data_group)
    mean /= pol.dp_size()
    return {"loss": mean, "grads": gather_params(grads, cfg, pol)}


def _lm_cut(groups, inp) -> dict:
    """``_lm`` of ``CUT_RUN`` with the attention module's ``copy_to`` cut
    for 2-D weights: MLA's w_dkv (q_norm, k_norm and kv_norm are 1-D)."""
    saved = attn_lib.copy_to
    attn_lib.copy_to = lambda x, group: x if x.dim() == 2 else saved(x, group)
    try:
        return _lm(groups, inp, CUT_RUN[0], CUT_RUN[2])
    finally:
        attn_lib.copy_to = saved


def _step(groups, inp) -> dict:
    """One AdamW step on (2 x 2) with ZeRO-1 moments over the data group."""
    arch, _, sp = STEP_RUN
    cfg = lm_cfg(arch)
    pol = ParallelPolicy(mesh=groups, seq_shard=sp)
    whole = lm_params_from_numpy(inp[f"lm_params_{arch}"], device="cpu")
    local = shard_params(whole, cfg, pol)
    shapes = tree_map(lambda p: tuple(p.shape), whole)
    layout = state_layout(groups, param_parts(cfg, pol, whole), shapes, grads_complete=True)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg, pol), AdamWConfig(**OPT_KW),
                           layout=layout)
    batch = {k: _rows(_t(inp[f"lm_{k}"]).long(), pol.data_group) for k in ("tokens", "targets")}
    local, _, metrics = step(local, init_opt_state(local, layout), batch)
    return {"params": gather_params(local, cfg, pol),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _roundtrip(groups, inp) -> dict:
    """For each reduced decoder config and each layout: whether
    gather(shard(params)) is bitwise the tree, and this rank's leaf
    shapes."""
    out = {}
    for arch, tree in inp["roundtrip"].items():
        cfg = reduced(get_arch(arch))
        whole = lm_params_from_numpy(tree, device="cpu")
        for layout, g in groups.items():
            pol = ParallelPolicy(mesh=g)
            local = shard_params(whole, cfg, pol)
            back = gather_params(local, cfg, pol)
            same = all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(whole)))
            out[arch, layout] = {"bitwise": same,
                                 "shapes": [tuple(t.shape) for t in _leaves(local)]}
    return out


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def run_checks(rank, world_size, device, inp):
    groups = {name: build_lm_groups(world_size, p) for name, p in LAYOUTS.items()}
    out = {"ulysses": _ulysses(groups["1x4"]["model"], inp),
           "head_padding": {name: _head_padding(groups["1x4"], inp, name)
                            for name in HEAD_PADDING},
           "moe_a2a_4.0": _moe(groups["2x2"], inp, "4.0", "2x2"),
           "moe_a2a_1.25": _moe(groups["2x2"], inp, "1.25", "2x2"),
           "moe_together": _moe(groups["4x1"], inp, "together", "4x1"),
           "lm": {(arch, layout, sp): _lm(groups[layout], inp, arch, sp)
                  for arch, layout, sp in LM_RUNS},
           "lm_cut": _lm_cut(groups[CUT_RUN[1]], inp),
           "step": _step(groups[STEP_RUN[1]], inp),
           "roundtrip": _roundtrip(groups, inp)}
    return out if rank == 0 else {"roundtrip": out["roundtrip"]}
