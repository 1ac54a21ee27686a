"""Process groups for the model-parallel FNO, and a launcher for its ranks.

Port of ``repro.launch.mesh``'s ``build_fno_mesh``, 1-D branch: where the
reference lays devices on a ("data", "model") mesh, the port builds one
``torch.distributed`` group per mesh row and column (``build_fno_groups``).

``launch_ranks`` starts the ranks: spawned processes that meet through a
``FileStore`` under a directory the caller names (no TCP port, so two
launches at once cannot collide), join one ``gloo`` process group, and run
a function. ``gloo`` because the ranks may share one card: NCCL refuses two
ranks on one device. On the card every rank runs on ``cuda:rank % count``;
on the CPU (only when the caller names it) each rank runs one thread. A
rank that raises or outlives the deadline ends the launch with an error,
and every rank still running is killed.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.common.device import resolve_device
from repro_torch.core.partition import PENCILS


def build_fno_groups(world_size: int, model_shards: Sequence[int]):
    """(data_group, model_group, n_model) of this rank from the world size
    and ``--model-shards``. One shard value P decomposes the solution along
    x (paper Alg. 2): ranks d*P .. d*P + P - 1 form model group d, and ranks
    m, m + P, ... data group m, as on the reference's row-major (data,
    model) mesh. Every rank creates every group, in the same order
    (``dist.new_group`` is collective). With P = 1 each rank's model group
    holds that rank alone, so nothing is sharded over it.
    """
    model_shards = tuple(int(s) for s in model_shards)
    if len(model_shards) == 2:
        raise ValueError(
            f"model shards {model_shards}: two values ask for 2-D pencils; {PENCILS}")
    if len(model_shards) != 1 or model_shards[0] < 1:
        raise ValueError(f"model shards take 1 value >= 1 (x-decomposition), got {model_shards}")
    n_model = model_shards[0]
    if world_size % n_model:
        raise ValueError(f"{world_size} ranks not divisible by {n_model} model shards")
    n_dp = world_size // n_model
    rank = dist.get_rank()
    model_groups = [dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
                    for d in range(n_dp)]
    data_groups = [dist.new_group(list(range(m, world_size, n_model))) for m in range(n_model)]
    return data_groups[rank % n_model], model_groups[rank // n_model], n_model


def _rank_main(rank, fn, world_size, run_dir, device_type, timeout_s, args):
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
        device = torch.device(device_type)
    store = dist.FileStore(os.path.join(run_dir, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, device, *args)
        torch.save(result, os.path.join(run_dir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch_ranks(
    fn: Callable,
    world_size: int,
    rendezvous_dir: str,
    *,
    args: tuple = (),
    timeout_s: float = 240.0,
    device=None,
) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks
    and return what each returned, in rank order.

    ``fn`` must be importable by name (the ranks are spawned); what it
    returns travels through ``torch.save`` (tensors, numbers, strings and
    containers of them). Ranks run on ``device``'s type: ``cuda`` unless
    the caller names the CPU. Raises if a rank raises, or when
    ``timeout_s`` passes first; no rank outlives the call.
    """
    device_type = resolve_device(device).type
    os.makedirs(rendezvous_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as run_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, run_dir, device_type, timeout_s, tuple(args)),
            nprocs=world_size, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s:.0f}s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(run_dir, f"result{r}.pt"), weights_only=True)
                for r in range(world_size)]
