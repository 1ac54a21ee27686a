"""What each rank of ``tests/test_torch_pipeline.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_pipeline`` runs on every one of 4 gloo ranks on
the CPU: the GPipe forward over a (1 x 4) stage group (4 blocks, 4
stages, 2 micro-batches), its trace and its refusals, one forward +
backward with the plain versions' calls counted, and top-k compression
with error feedback over the 4 ranks as one data group. Rank 0 returns
the gathered outputs and gradients, every rank its compression results,
which the test holds against the JAX reference in its own process.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fno
from repro_torch.core.partition import gather_tree
from repro_torch.core.pipeline import (
    make_pipeline_forward, pipeline_param_partitions, reduce_pipeline_grads,
    shard_pipeline_params,
)
from repro_torch.kernels.spectral_conv import ops
from repro_torch.launch.mesh import build_fno_groups
from repro_torch.train import compression
from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree

N_MICRO = 2
RATIOS = (1.0, 0.1)


class _Counted:
    """Counts the calls of the spectral op's plain versions (what runs in
    place of the kernels on the CPU)."""

    def __init__(self):
        self.calls = {"fused": 0, "dw": 0}
        self._orig = (ops.spectral_apply_fused_ref, ops.spectral_fused_dw_ref)

    def __enter__(self):
        fused, dw = self._orig

        def fused_counted(*a, **k):
            self.calls["fused"] += 1
            return fused(*a, **k)

        def dw_counted(*a, **k):
            self.calls["dw"] += 1
            return dw(*a, **k)

        ops.spectral_apply_fused_ref, ops.spectral_fused_dw_ref = fused_counted, dw_counted
        return self.calls

    def __exit__(self, *exc):
        ops.spectral_apply_fused_ref, ops.spectral_fused_dw_ref = self._orig


def _refusals(cfg, model, local, x) -> dict:
    out = {}
    for name, call in (
            ("n_blocks", lambda: make_pipeline_forward(
                dataclasses.replace(cfg, n_blocks=2), model, n_micro=N_MICRO)),
            ("batch", lambda: make_pipeline_forward(cfg, model, n_micro=3)(local, x)),
            ("group", lambda: make_pipeline_forward(cfg, None, n_micro=N_MICRO))):
        try:
            call()
            out[name] = "not refused"
        except ValueError as e:
            out[name] = str(e)
    return out


def _compression(rank, world_size, group, device) -> dict:
    """Every ratio on this rank's rows of the seeded per-rank gradients
    (the same numpy draws the test makes), a complex leaf, and the dict
    form with a leaf too small to compress."""
    rng = np.random.default_rng(0)
    g_all = rng.standard_normal((world_size, 256)).astype(np.float32)
    c_all = (rng.standard_normal((world_size, 8, 16))
             + 1j * rng.standard_normal((world_size, 8, 16))).astype(np.complex64)
    tiny_all = rng.standard_normal((world_size, 5)).astype(np.float32)
    g = torch.from_numpy(g_all[rank]).to(device)
    out = {}
    for ratio in RATIOS:
        red, err = compression.compress_leaf(g, torch.zeros_like(g), group, ratio)
        k = max(1, int(g.numel() * ratio))
        _, idx = compression._topk_sparsify(g, k)
        out[f"real_{ratio}"] = {"reduced": red.cpu(), "err": err.cpu(),
                                "idx": sorted(idx.cpu().tolist())}
    c = torch.from_numpy(c_all[rank]).to(device)
    red, err = compression.compress_leaf(c, torch.zeros_like(c), group, 0.1)
    _, idx = compression._topk_sparsify(c, max(1, int(c.numel() * 0.1)))
    out["complex_0.1"] = {"reduced": red.cpu(), "err": err.cpu(), "idx": sorted(idx.cpu().tolist())}
    tree = {"a": {"w": g}, "b": {"tiny": torch.from_numpy(tiny_all[rank]).to(device)}}
    red, err = compression.compressed_psum_mean(
        tree, compression.init_error_state(tree), group, ratio=0.1)
    out["tree"] = {"reduced": {k: {n: t.cpu() for n, t in v.items()} for k, v in red.items()},
                   "err": {k: {n: t.cpu() for n, t in v.items()} for k, v in err.items()}}
    return out


def run_pipeline(rank, world_size, device, params_np, x_np, cfg_kwargs):
    """One rank's share: rank 0 returns the outputs, gradients and launch
    counts; every rank its trace, launch counts and compression results."""
    cfg = fno.FNOConfig(**cfg_kwargs)
    data_group, model, _ = build_fno_groups(world_size, [world_size])
    groups = {"model": model}
    params = fno.params_from_numpy(params_np, device)
    local = shard_pipeline_params(params, model)
    x = torch.from_numpy(x_np).to(device)
    fwd = make_pipeline_forward(cfg, model, n_micro=N_MICRO)
    out = {"refusals": _refusals(cfg, model, local, x)}

    trace = []
    with torch.no_grad(), _Counted() as calls:
        y = fwd(local, x, trace)
    out["forward"] = {"y": y, "calls": dict(calls), "trace": trace}

    grads = zeros_like_tree(local)
    with _Counted() as calls:
        loss, _ = accumulate_grads(lambda p, b: (fwd(p, b).square().mean(), {}), local, x, grads)
    reduce_pipeline_grads(grads, model)
    out["backward"] = {"loss": float(loss), "calls": dict(calls),
                       "grads": gather_tree(grads, pipeline_param_partitions(), groups)}

    data_group, _, _ = build_fno_groups(world_size, [1])  # every rank one data group
    out["compression"] = _compression(rank, world_size, data_group, device)
    dist.barrier()
    return out
