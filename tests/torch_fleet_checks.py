"""What each rank of ``tests/test_torch_fleet.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_fleet_checks`` runs on every one of 4 gloo
ranks on the CPU: for each of ``FLEETS``, ``REPLICAS`` ranked
``FNORunner``s over (1 data x 4 model), built alike on every rank and
linked by ``link_replicas``, serve one start of the ranks as a fleet. Rank
0 drives the port's ``Gateway`` and closes once it drains; the others run
one ``follow`` loop over their replicas. The ``deep`` fleet serves a
second wave after rank 0 has made replica 0 raise before its header (its
``step`` replaced), so the gateway fails over to the survivor, which hits
the shared store. Every rank reports the ticks it ran on each replica;
rank 0 also returns each wave's outputs and the gateway's counters, which
the test holds against the serial port runner and the JAX runner in its
own process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import fno
from repro_torch.data.loader import Normalizer
from repro_torch.launch.mesh import build_fno_groups
from repro_torch.serve import DictCacheStore, FNORunner, Gateway, ScenarioRequest, link_replicas

N_STATIC = 1
MODEL_SHARDS = [4]
REPLICAS = 2
BUCKET = 2
SERVE_STEPS = 2
# (name, cache level, gateway policy, a replica fails before the second wave)
FLEETS = (("deep", "deep", "affinity", True), ("prelift", "prelift", "least-pending", False))


def _wave(gw, xs) -> list:
    reqs = [ScenarioRequest(rid=i, x=x.copy(), steps=SERVE_STEPS) for i, x in enumerate(xs)]
    for r in reqs:
        gw.submit(r)
    gw.run_until_done(max_steps=100)
    if gw.failed or not all(r.done and r.error is None for r in reqs):
        raise RuntimeError(f"served {len(gw.finished)}: {[r.error for r in gw.failed]}")
    return [[torch.from_numpy(y) for y in r.outputs] for r in reqs]


def _dead_step(slots, active):
    raise RuntimeError("simulated replica hardware failure")


def _serve_fleet(runners, xs, policy, fail) -> dict:
    """Rank 0's share: one wave through the gateway, then (``fail``)
    replica 0 raising before its header and a second wave; closes once."""
    gw = Gateway(runners, policy=policy)
    out = {"waves": [_wave(gw, xs)]}
    out["routed_first_wave"] = [h.routed for h in gw.replicas]
    if fail:
        runners[0].step = _dead_step
        out["waves"].append(_wave(gw, xs))
    runners[0].close()
    stats = gw.stats()
    out.update(routed=[h.routed for h in gw.replicas], healthy=[h.healthy for h in gw.replicas],
               rerouted=gw.rerouted, store=stats["fleet"]["store"],
               survivor_entries=runners[1].cache.stats["entries"],
               cache_hit_rate=stats["fleet"]["cache_hit_rate"])
    return out


def run_fleet_checks(rank, world_size, device, params_np, xs, cfg_kwargs, stats):
    """One rank's share; returns the ticks it ran on each replica of each
    fleet, and on rank 0 what each fleet served."""
    cfg = fno.FNOConfig(**cfg_kwargs)
    data_group, model, _ = build_fno_groups(world_size, MODEL_SHARDS)
    local = fno.shard_params(fno.params_from_numpy(params_np, device), model)
    norms = [Normalizer.from_stats(stats[k], "meanstd") for k in ("x", "y")]
    ticks, served = {}, {}
    for name, level, policy, fail in FLEETS:
        store = DictCacheStore() if rank == 0 else None
        runners = [FNORunner(cfg, local, device=device, data_group=data_group, model=model,
                             max_slots=BUCKET, buckets=(BUCKET,), x_normalizer=norms[0],
                             y_normalizer=norms[1], n_static=N_STATIC, cache_level=level,
                             cache_store=store)
                   for _ in range(REPLICAS)]
        link_replicas(runners)
        if rank == 0:
            served[name] = _serve_fleet(runners, xs, policy, fail)
            served[name]["refusals"] = _refusals(runners)
        else:
            runners[0].follow()
        ticks[name] = [len(r.tick_times) for r in runners]
    every = [None] * world_size
    dist.all_gather_object(every, ticks)
    return {"ticks": every, "served": served if rank == 0 else None}


def _refusals(runners) -> list:
    """What a closed fleet refuses on the controller: a tick on any replica
    (the followers have left their loop) and a new link."""
    out = []
    for what, call, kind in (("tick", runners[1].warmup, RuntimeError),
                             ("link", lambda: link_replicas(runners), ValueError)):
        try:
            call()
        except kind as e:
            out.append(f"{what}: {e}")
    return out
