"""What each rank of ``tests/test_torch_dryrun.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``param_bytes`` runs on every one of 4 gloo ranks on
the CPU: for every reduced config (f32 masters, seed 0), the bytes of this
rank's ``shard_params`` on (2 x 2) and (1 x 4), and on ranks 0 and 1 on
(1 x 2) (a model group of those two, a data group of one).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.launch.mesh import build_lm_groups
from repro_torch.models import init_lm_params, init_whisper_params
from repro_torch.models.policy import ONE_RANK, ParallelPolicy
from repro_torch.models.transformer import _leaves, shard_params


def whole_params(cfg) -> dict:
    init = init_whisper_params if cfg.family == "encdec" else init_lm_params
    return init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


def param_bytes(rank, world_size, device, _):
    pair = dist.new_group([0, 1])
    meshes = {"2x2": build_lm_groups(world_size, 2), "1x4": build_lm_groups(world_size, 4)}
    if rank < 2:
        meshes["1x2"] = {"data": ONE_RANK, "model": pair}
    out = {}
    for arch in ARCH_IDS:
        cfg = reduced(get_arch(arch))
        whole = whole_params(cfg)
        for name, mesh in meshes.items():
            out[arch, name] = _bytes(shard_params(whole, cfg, ParallelPolicy(mesh=mesh)))
    return out
