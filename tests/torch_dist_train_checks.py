"""What each rank of ``tests/test_torch_dist_train.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_train`` runs on every one of 4 gloo ranks on
the CPU: the distributed train step on three (data x model) layouts, the
(2 x 2) one with ZeRO-1 on and off, a checkpoint saved on (2 x 2) and
restored onto (1 x 2x2), and the per-rank loader reads of each layout.
Rank 0 returns the global values, gathered, which the test holds against
the JAX reference and the port's serial path in its own process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import fno
from repro_torch.core.partition import gather, gather_tree, shard, shard_tree
from repro_torch.data.loader import ShardedDatasetLoader
from repro_torch.data.store import ArrayStore
from repro_torch.launch.mesh import build_fno_groups
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, state_layout, warmup_cosine
from repro_torch.train.train_loop import make_train_step

# layout name -> --model-shards of 4 ranks: (1 data x 2x2 pencils), (2 data
# x 2 model, 1-D) and (4 data x 1 model, pure data parallelism)
LAYOUTS = {"1x2x2": [2, 2], "2x2": [2], "4x1": [1]}
CKPT_STEP = 1


def _layout(cfg, world_size, shards, zero1=True):
    data_group, model, _ = build_fno_groups(world_size, shards)
    groups = fno.group_names(data_group, model)
    forward, x_part, p_parts = fno.forward_and_specs(cfg, model)
    layout = state_layout(groups, p_parts, fno.param_shapes(cfg), zero1=zero1)
    return forward, x_part, layout


def _steps(cfg, forward, x_part, layout, params_np, batches_np, opt_kw, accum, device):
    """The train step over ``batches_np`` from ``params_np``: (per-step
    metrics, this rank's final state)."""
    groups = layout.groups
    # a copy: params_from_numpy shares the arrays' memory, which AdamW updates in place
    fresh = {k: {n: t.clone() for n, t in v.items()}
             for k, v in fno.params_from_numpy(params_np, device).items()}
    params = shard_tree(fresh, layout.params, groups)
    opt = init_opt_state(params, layout)
    step = make_train_step(
        lambda p, b: (fno.mse_loss(forward(p, b["x"]), b["y"]), {}),
        AdamWConfig(lr=warmup_cosine(1e-2, 1, 4), **opt_kw), grad_accum=accum, layout=layout)
    metrics = []
    for b in batches_np:
        batch = {k: shard(torch.from_numpy(v).to(device), x_part, groups) for k, v in b.items()}
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {"params": params, "opt": opt}


def run_train(rank, world_size, device, params_np, batches_np, cfg_kwargs, opt_kw, accum,
              store_root, ckpt_dir):
    """One rank's share; returns rank 0's gathered results (other ranks:
    their check of what only they can see)."""
    cfg = fno.FNOConfig(**cfg_kwargs)
    out = {"steps": {}, "loader": {}}
    for name, shards in LAYOUTS.items():
        for zero1 in ((True, False) if name == "2x2" else (True,)):
            forward, x_part, layout = _layout(cfg, world_size, shards, zero1)
            metrics, state = _steps(cfg, forward, x_part, layout, params_np, batches_np,
                                    opt_kw, accum, device)
            key = name if zero1 else f"{name}_no_zero1"
            out["steps"][key] = {"metrics": metrics,
                                 "state": gather_tree(state, layout.state(), layout.groups),
                                 "mu_shapes": [tuple(t.shape) for t in
                                               _leaves(state["opt"]["mu"])]}
            if name == "2x2" and zero1:
                checkpoint.save(ckpt_dir, CKPT_STEP, state, parts=layout.state(),
                                groups=layout.groups)
        sources = {k: ArrayStore.open(f"{store_root}/{k}") for k in ("x", "y")}
        with ShardedDatasetLoader(sources, len(batches_np[0]["x"]), device=device, seed=3,
                                  prefetch=2, part=x_part, groups=layout.groups) as loader:
            out["loader"][name] = [
                {k: gather(v, x_part, layout.groups) for k, v in loader.batch(s).items()}
                for s in (0, 1, 2, 0)]
    dist.barrier()  # rank 0's save is on disk before any rank reads it
    _, _, layout = _layout(cfg, world_size, LAYOUTS["1x2x2"])
    fresh = shard_tree(fno.init_params(cfg, device=device), layout.params, layout.groups)
    state = {"params": fresh, "opt": init_opt_state(fresh, layout)}
    step, _ = checkpoint.restore_into(ckpt_dir, state, parts=layout.state(), groups=layout.groups)
    out["restored_on_1x2x2"] = {"step": step,
                                "state": gather_tree(state, layout.state(), layout.groups)}
    if rank != 0:
        out = {"mu_shapes": {k: v["mu_shapes"] for k, v in out["steps"].items()}}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree
