"""Process groups for the model-parallel FNO and the distributed LM, and a launcher for their ranks.

Port of ``repro.launch.mesh``'s ``build_fno_mesh``: where the reference
lays devices on a ("data", "model") or ("data", "mx", "my") mesh, the port
builds one ``torch.distributed`` group per mesh row and column
(``build_fno_groups``); ``core.fno.group_names`` names them as the
reference names its axes.

``launch_ranks`` starts the ranks: spawned processes that meet through a
``FileStore`` under a directory the caller names (no TCP port, so two
launches at once cannot collide), join one ``gloo`` process group, and run
a function. ``gloo`` because the ranks may share one card: NCCL refuses two
ranks on one device. On the card every rank runs on ``cuda:rank % count``;
on the CPU (only when the caller names it) each rank runs one thread.

Two limits guard a launch. The collective timeout bounds how long a rank
waits in one collective for its peers, so a hung or dead peer fails the
launch; it does not bound the run, which may last as long as its ranks
keep working. A wall-clock deadline is opt-in, for tests and smoke runs.
A rank that raises, or a launch past its deadline, ends with an error,
and every rank still running is killed.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.common.device import resolve_device

# Group names understood as model-parallel: "model" (1-D, paper Alg. 2) and
# the ("mx", "my") pair (2-D pencil decomposition).
MODEL_AXIS_NAMES = ("model", "mx", "my")


def fno_layout(world_size: int, model_shards: Sequence[int]) -> tuple:
    """(n_dp, model_shards, n_model) of ``world_size`` ranks under
    ``--model-shards``, or ValueError for a layout the FNO cannot take: one
    value P (x-decomposition) or two PX PY (x, y pencils), whose product
    divides the rank count. Needs no process group."""
    model_shards = tuple(int(s) for s in model_shards)
    if not 1 <= len(model_shards) <= 2 or min(model_shards) < 1:
        raise ValueError(
            f"model shards take 1 (x-decomposition) or 2 (x,y pencil) "
            f"values >= 1, got {len(model_shards)}: {model_shards}")
    n_model = 1
    for s in model_shards:
        n_model *= s
    if world_size % n_model:
        raise ValueError(f"{world_size} devices not divisible by {n_model} model shards")
    return world_size // n_model, model_shards, n_model


def build_fno_groups(world_size: int, model_shards: Sequence[int]):
    """(data_group, model, n_model) of this rank from the world size and
    ``--model-shards``.

    One shard value P decomposes the solution along x (paper Alg. 2):
    ``model`` is this rank's model group; ranks d*P .. d*P + P - 1 form
    model group d, and ranks m, m + P, ... data group m, as on the
    reference's row-major (data, model) mesh. With P = 1 each rank's model
    group holds that rank alone, so nothing is sharded over it.

    Two values PX PY give the 2-D pencils: ``model`` is the pair (mx_group,
    my_group). The ranks lie row-major on (data, mx, my), as the
    reference's ``make_pencil_mesh`` lays its devices: rank = d*PX*PY +
    i*PY + j holds x shard i (its rank in the mx group) and y shard j (its
    rank in the my group).

    Every rank creates every group, in the same order (``dist.new_group``
    is collective).
    """
    n_dp, shards, n_model = fno_layout(world_size, model_shards)
    rank = dist.get_rank()
    data_groups = [dist.new_group(list(range(m, world_size, n_model))) for m in range(n_model)]
    data_group = data_groups[rank % n_model]
    if len(shards) == 1:
        model_groups = [dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
                        for d in range(n_dp)]
        return data_group, model_groups[rank // n_model], n_model
    px, py = shards
    d, i, j = rank // n_model, rank % n_model // py, rank % py
    mx_groups = {(dd, jj): dist.new_group([dd * n_model + ii * py + jj for ii in range(px)])
                 for dd in range(n_dp) for jj in range(py)}
    my_groups = {(dd, ii): dist.new_group([dd * n_model + ii * py + jj for jj in range(py)])
                 for dd in range(n_dp) for ii in range(px)}
    return data_group, (mx_groups[d, j], my_groups[d, i]), n_model


def build_lm_groups(world_size: int, model_shards: int) -> dict:
    """The ("data", "model") groups of a distributed LM on ``world_size``
    ranks with ``model_shards`` ranks to a model group, as a mesh policy
    takes them (``models.policy.ParallelPolicy(mesh=...)``): the ranks lie
    row-major on (data, model), as ``build_fno_groups`` lays them for one
    shard value, with ``fno_layout``'s checks and words."""
    data_group, model_group, _ = build_fno_groups(world_size, [model_shards])
    return {"data": data_group, "model": model_group}


def dp_axes_for(groups: Mapping[str, object]) -> tuple:
    """Data-parallel group names: every name that is not a model axis."""
    return tuple(a for a in groups if a not in MODEL_AXIS_NAMES)


# How long the ranks may take to start (spawn, imports, CUDA context) before
# they connect; the collective timeout applies only once every rank is up.
STARTUP_TIMEOUT_S = 300.0


def _rank_main(rank, fn, world_size, run_dir, device_type, collective_timeout_s, args):
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
        device = torch.device(device_type)
    store = dist.FileStore(os.path.join(run_dir, "store"), world_size)
    store.set(f"up{rank}", "1")
    store.wait([f"up{r}" for r in range(world_size)],
               datetime.timedelta(seconds=STARTUP_TIMEOUT_S))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=collective_timeout_s))
    # every rank has connected before any runs fn: a rank that returns
    # early must not close its connections under a peer still connecting
    dist.barrier()
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
    collective_timeout_s: float = 1800.0,
    deadline_s: Optional[float] = None,
    device=None,
) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks
    and return what each returned, in rank order.

    ``fn`` must be importable by name (the ranks are spawned); what it
    returns travels through ``torch.save`` (tensors, numbers, strings and
    containers of them). Ranks run on ``device``'s type: ``cuda`` unless
    the caller names the CPU. ``collective_timeout_s`` is how long a rank
    waits in one collective for its peers (gloo's timeout); with
    ``deadline_s`` the launch also ends after that much wall time. Raises
    if a rank raises, or at the deadline; no rank outlives the call.
    """
    device_type = resolve_device(device).type
    os.makedirs(rendezvous_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as run_dir:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world_size, run_dir, device_type, collective_timeout_s, tuple(args)),
            nprocs=world_size, join=False, start_method="spawn",
        )
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within {deadline_s:.0f}s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(run_dir, f"result{r}.pt"), weights_only=True)
                for r in range(world_size)]
