"""Serve the trained CO2 surrogate on one device or model-parallel over
ranks: UQ-ensemble inference through the slot scheduler.

Draws N permeability/well-placement scenarios the way the reference's
serving CLI does, serves them through ``FNORunner.from_checkpoint`` (the fused
CUDA spectral kernel on the card), and reports scenarios/s plus
per-request latency.

    PYTHONPATH=src python -m repro_torch.launch.serve_pde --ckpt-dir CKPT \
        --scenarios 8 --verify --bench-sequential [--max-steps S] \
        [--devices N --model-shards P | PX PY] [--comm-chunks C] \
        [--replicas R --policy affinity [--ensemble --cache-store DIR|dict]]

``CKPT`` is a directory written by the reference's ``train.py --mode fno``
or the port's. ``--devices N`` starts N ranks (``launch.mesh.launch_ranks``,
gloo, no wall-clock deadline) laid out as (data x model) by
``--model-shards``; by default the layout the checkpoint recorded, on as
many ranks as it has model shards. Rank 0 serves and prints. ``--verify``
replays every served scenario through the port's unfused plain forward,
restored from the same checkpoint on one device (after the ranks exit),
and exits non-zero on a mismatch beyond rtol=1e-4, atol=1e-5;
``--bench-sequential`` also serves the ensemble one at a time over the
same warm runner; ``--reference`` then times the numerical simulator
(``data/pde/two_phase.py``) on one scenario at the served grid, on the
serving device, and prints the surrogate-vs-simulator speedup against the
served per-scenario time (of rank 0's serving pass with ``--devices N``).
``--replicas R`` serves through the gateway (``serve.gateway``): R
replicas restored from the checkpoint, routed by ``--policy``, sharing one
``--cache-store`` with ``--ensemble``; with ``--devices N`` every rank
builds the R replicas and one start of the ranks serves the fleet
(``fno_runner.link_replicas``). ``--max-steps`` budgets each serving pass's
scheduler (or gateway) steps. ``--device cpu`` runs on the CPU; the
default is the card.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch


def build_scenarios(cfg, n: int, wells: int, seed: int, steps: int,
                    n_static: int = 0, dup: int = 1):
    """N well-placement scenarios in the model's input layout.

    ``n_static > 0`` builds the UQ-ensemble workload: the first channels
    are the SHARED log-permeability geomodel (byte-identical across every
    scenario), only the well channel varies. ``dup`` submits each scenario
    that many times (the scheduler dedups them in flight).
    """
    from repro_torch.data.pde.two_phase import (
        TwoPhaseConfig, geomodel_channel, random_well_mask,
    )
    from repro_torch.serve import ScenarioRequest

    nx, ny, nz, nt = cfg.grid
    sim_cfg = TwoPhaseConfig(grid=(nx, ny, nz), nt_frames=nt)
    geo = None
    if n_static:
        one = geomodel_channel((nx, ny, nz), nt)
        geo = np.concatenate([one] * n_static, axis=0)[:n_static]
    requests, rid = [], 0
    n_dyn = cfg.in_channels - n_static
    for i in range(n):
        mask = random_well_mask(sim_cfg, wells, seed + i)
        x = np.repeat(mask[None, :, :, :, None], nt, axis=-1).astype(np.float32)
        if n_dyn > 1:
            x = np.concatenate([x] * n_dyn, axis=0)[:n_dyn]
        if geo is not None:
            x = np.concatenate([geo, x], axis=0)
        for _ in range(max(1, dup)):
            requests.append(ScenarioRequest(rid=rid, x=x.copy(), steps=steps))
            rid += 1
    return requests, sim_cfg


def oracle_rollout(runner, x_raw: np.ndarray, steps: int):
    """Per-request reference: the unfused plain forward (batch 1, same
    device, same params) through the same normalize -> forward ->
    de-normalize -> feedback chain. No fused kernel runs in it, so it is a
    fused-vs-unfused gate on the served outputs."""
    from repro_torch.core.fno import fno_forward_unfused

    n_static = runner.n_static
    outs, x = [], np.asarray(x_raw, np.float32)
    for _ in range(steps):
        xe = torch.from_numpy(runner.x_normalizer.encode(x[None])).to(runner.device)
        with torch.inference_mode():
            y = fno_forward_unfused(runner.params, xe, runner.cfg).cpu().numpy()
        y_raw = runner.y_normalizer.decode(y)[0]
        outs.append(y_raw)
        fb = runner.feedback(y_raw)
        # with static geomodel channels, feedback evolves only the dynamic
        # channels — the geomodel persists (mirrors FNORunner.step)
        x = np.concatenate([x[:n_static], fb], axis=0) if n_static else fb
    return outs


def serve(runner, requests, max_slots: int, max_steps: int):
    """(finished, seconds, scheduler) for one serving pass over
    ``requests``; callers check ``sched.failed`` (``check_served``)."""
    from repro_torch.serve import Scheduler

    sched = Scheduler(runner, max_slots)
    for r in requests:
        sched.submit(r)
    t0 = time.perf_counter()
    done = sched.run_until_done(max_steps=max_steps)
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    dt = time.perf_counter() - t0
    return done, dt, sched


def check_served(done, requests, failed):
    """Exit non-zero with the per-request errors when the ensemble did not
    fully serve."""
    for r in failed:
        print(f"scenario rid={r.rid} FAILED: {r.error}", file=sys.stderr)
    if failed:
        raise SystemExit(
            f"{len(failed)}/{len(requests)} scenario(s) failed "
            f"(errors above); {len(done)} served"
        )
    if len(done) != len(requests):
        raise SystemExit(
            f"served {len(done)}/{len(requests)} scenarios; "
            f"raise --max-steps"
        )


def verify(runner, done, steps: int) -> float:
    """Check every served output against ``oracle_rollout`` at rtol=1e-4,
    atol=1e-5; returns the largest absolute difference."""
    worst = 0.0
    for r in done:
        expected = oracle_rollout(runner, r.x, steps)
        for got, exp in zip(r.outputs, expected):
            worst = max(worst, float(np.abs(got - exp).max()))
            np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)
    return worst


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.serve.gateway import POLICIES

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True,
                    help="train.py --mode fno checkpoint directory")
    ap.add_argument("--scenarios", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4, help="scheduler slots")
    ap.add_argument("--rollout-steps", type=int, default=1,
                    help="autoregressive surrogate applications per scenario")
    ap.add_argument("--wells", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=10000,
                    help="scheduler (or gateway) steps each serving pass may take")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas behind the gateway; each is an "
                    "independent FNORunner + scheduler restored from the "
                    "same checkpoint (1 = the single-scheduler path)")
    ap.add_argument("--policy", default="affinity", choices=POLICIES,
                    help="gateway routing policy (--replicas > 1): "
                    "backlog-aware least-pending, cyclic round-robin, or "
                    "geomodel cache-affinity with least-pending fallback")
    ap.add_argument("--ensemble", action="store_true",
                    help="UQ-ensemble mode: every scenario shares the same "
                    "geomodel (static channels), only well locations vary; "
                    "serves through the geomodel cache and reports its "
                    "hit-rate")
    ap.add_argument("--static-channels", type=int, default=1,
                    help="ensemble mode: leading input channels that are "
                    "the static geomodel")
    ap.add_argument("--cache-bytes", type=int, default=256 << 20,
                    help="geomodel-cache byte budget (LRU beyond it)")
    ap.add_argument("--cache-level", default="deep",
                    choices=("prelift", "deep"),
                    help="ensemble cache depth: 'prelift' stops at the "
                    "encoder lift; 'deep' also caches the first block's "
                    "static spectral contribution")
    ap.add_argument("--cache-store", default=None,
                    help="fleet-shared cache store replicas consult on "
                    "local miss (with --ensemble): 'dict' for an in-process "
                    "shared dict, or a directory for a file-backed (.npz) "
                    "store that persists across runs")
    ap.add_argument("--dup", type=int, default=1,
                    help="submit each scenario this many times (identical "
                    "in-flight requests dedup onto one slot)")
    ap.add_argument("--verify", action="store_true",
                    help="check every served output against the unfused "
                    "plain forward (exit non-zero on mismatch)")
    ap.add_argument("--bench-sequential", action="store_true",
                    help="also serve one at a time and report the "
                    "continuous-batching speedup")
    ap.add_argument("--reference", action="store_true",
                    help="time the numerical simulator on one scenario for "
                    "the surrogate-vs-simulator speedup")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; 'cpu' "
                    "runs on the CPU)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks to serve on (default: one per model shard of "
                    "the layout)")
    ap.add_argument("--model-shards", type=int, nargs="+", default=None,
                    help="model parallelism of the serving ranks: P shards x "
                    "(paper Alg. 2), PX PY the 2-D pencils; default: the "
                    "layout recorded in the checkpoint's fno_config.json")
    ap.add_argument("--comm-chunks", type=int, default=None,
                    help="channel-chunked all-to-alls of the dist forward; "
                    "default: the checkpoint's recorded value")
    return ap


def _runner_kwargs(args) -> dict:
    n_static = args.static_channels if args.ensemble else 0
    return dict(max_slots=args.max_batch, n_static=n_static, cache_bytes=args.cache_bytes,
                cache_level=args.cache_level, comm_chunks=args.comm_chunks)


def _replicas(args, **kw) -> list:
    """The ``--replicas`` runners restored from the checkpoint (on every
    rank alike with the groups in ``kw``), sharing one cache store (the
    point of the tier; only with ``--ensemble``, and only the controller
    holds it) and linked to share the ranks."""
    from repro_torch.serve import FNORunner, link_replicas, open_cache_store

    rkw = _runner_kwargs(args)
    controller = kw.get("data_group") is None or torch.distributed.get_rank() == 0
    store = (open_cache_store(args.cache_store)
             if args.cache_store and rkw["n_static"] and controller else None)
    runners = [FNORunner.from_checkpoint(args.ckpt_dir, cache_store=store, **kw, **rkw)
               for _ in range(args.replicas)]
    link_replicas(runners)
    return runners


def _layout(args, cfg, saved) -> tuple:
    """(devices, model_shards) of the serving ranks, checked against the
    checkpoint's config; exits with the reference's wording on a layout
    the flags cannot make."""
    from repro_torch.launch.mesh import fno_layout

    shards = tuple(int(s) for s in args.model_shards or saved.get("model_shards") or (1,))
    try:
        devices = int(np.prod(shards)) if args.devices is None else args.devices
        fno_layout(devices, shards)
        if len(shards) == 2:
            cfg.validate_for_parallelism_2d(*shards)
        elif shards[0] > 1:
            cfg.validate_for_parallelism(shards[0])
        n_static = args.static_channels if args.ensemble else 0
        if not 0 <= n_static <= cfg.in_channels:
            raise ValueError(f"n_static={n_static} must be in [0, in_channels="
                             f"{cfg.in_channels}]")
    except ValueError as e:  # library error -> CLI-flag wording
        raise SystemExit(f"--devices/--model-shards/--static-channels: {e}") from None
    return devices, shards


def _serve_rank(rank, world_size, device, args, shards):
    """One serving rank of ``--devices N``: rank 0 serves and returns each
    served request's outputs by rid; the others follow its ticks."""
    from repro_torch.launch.mesh import build_fno_groups

    data_group, model, _ = build_fno_groups(world_size, shards)
    runners = _replicas(args, device=device, data_group=data_group, model=model)
    if rank != 0:
        runners[0].follow()
        return None
    done, dt = _serve_and_report(runners, args, f" (rank 0 of {world_size})")
    runners[0].close()
    return {"dt": dt, "outputs": {r.rid: [torch.from_numpy(y) for y in r.outputs] for r in done}}


def main(argv=None) -> list:
    """Serve the ensemble the flags describe; returns the served requests
    (their ``outputs`` in physical units)."""
    args = build_parser().parse_args(argv)
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    from repro_torch.common.device import resolve_device
    from repro_torch.serve import FNORunner
    from repro_torch.serve.fno_runner import load_serving_config

    device = resolve_device(args.device)
    cfg, saved = load_serving_config(args.ckpt_dir, args.comm_chunks)
    devices, shards = _layout(args, cfg, saved)
    runner = None
    if devices == 1:
        try:
            runners = _replicas(args, device=device)
        except ValueError as e:  # library error -> CLI-flag wording
            raise SystemExit(f"--static-channels/--max-batch: {e}") from None
        runner = runners[0]
        done, dt = _serve_and_report(runners, args, "")
    else:
        from repro_torch.launch.mesh import launch_ranks

        sys.stdout.flush()  # the ranks print to the same stream
        served = launch_ranks(_serve_rank, devices, tempfile.gettempdir(),
                              args=(args, shards), device=device)[0]
        done, _ = build_scenarios(cfg, args.scenarios, args.wells, args.seed,
                                  args.rollout_steps, n_static=_runner_kwargs(args)["n_static"],
                                  dup=args.dup)
        for r in done:
            r.outputs = [y.numpy() for y in served["outputs"][r.rid]]
        dt = served["dt"]
    if args.verify:
        if runner is None:  # the oracle: the same checkpoint on one device
            runner = FNORunner.from_checkpoint(args.ckpt_dir, device=device,
                                               **dict(_runner_kwargs(args), max_slots=1))
        worst = verify(runner, done, args.rollout_steps)
        print(f"verify OK: {len(done)} scenarios match the unfused plain forward "
              f"(max abs diff {worst:.2e})")
    if args.reference:
        _report_reference(args, cfg, device, dt / len(done))
    return done


def _report_reference(args, cfg, device, per_scen: float) -> None:
    """Time one ``simulate_task`` at the served scenario grid on ``device``
    (synchronised: it returns host arrays) and print the reference's
    speedup line."""
    from repro_torch.data.pde.two_phase import simulate_task

    nx, ny, nz, nt = cfg.grid
    t0 = time.perf_counter()
    simulate_task(args.seed, args.wells, (nx, ny, nz), nt, device=device)
    sim_s = time.perf_counter() - t0
    print(
        f"reference simulator: {sim_s:.2f}s/scenario vs surrogate "
        f"{per_scen * 1e3:.1f}ms/scenario -> {sim_s / per_scen:.0f}x "
        f"(paper reports ~1e5x at Sleipner scale on real accelerators)"
    )


def _serve_and_report(runners, args, of_ranks: str) -> tuple:
    """Warm up, serve the ensemble of ``args`` (through the gateway when
    there are several replicas) and print what was served; returns the
    served requests and the serving pass's seconds."""
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.serve import Gateway

    runner = runners[0]
    n_static = runner.n_static
    cfg = runner.cfg
    print(
        f"serving {cfg.grid} FNO (width {cfg.width}, {cfg.n_blocks} blocks) "
        f"from step {runner.restored_step} on {runner.device}{of_ranks} "
        f"(buckets {runner.buckets}"
        + (f", {len(runners)} replicas policy={args.policy})" if len(runners) > 1 else ")")
    )
    warm_s = sum(r.warmup() for r in runners)

    requests, _ = build_scenarios(
        cfg, args.scenarios, args.wells, args.seed, args.rollout_steps,
        n_static=n_static, dup=args.dup,
    )
    spectral_fused_cuda.launches = 0
    fleet = None
    if len(runners) == 1:
        done, dt, sched = serve(runner, requests, args.max_batch, args.max_steps)
        launches = spectral_fused_cuda.launches
        check_served(done, requests, sched.failed)
        engine_steps, dedup_attached = sched.steps, sched.dedup_attached
    else:
        gateway = Gateway(runners, policy=args.policy)
        for r in requests:
            gateway.submit(r)
        t0 = time.perf_counter()
        done = gateway.run_until_done(max_steps=args.max_steps)
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        dt = time.perf_counter() - t0
        launches = spectral_fused_cuda.launches
        check_served(done, requests, gateway.failed)
        stats = gateway.stats()
        fleet = stats["fleet"]
        engine_steps, dedup_attached = fleet["ticks"], fleet["dedup_attached"]
        for rs in stats["replicas"]:
            print(
                f"  replica {rs['name']}: routed {rs['routed']}, served "
                f"{rs['finished']}, backlog {rs['pending']}, healthy "
                f"{rs['healthy']}"
                + (f", cache hit-rate {rs['cache']['hit_rate']:.3f} "
                   f"({rs['cache']['bytes'] / 1e6:.2f} MB)"
                   if rs["cache"] else "")
            )
    forwards = sum(r.batched_steps for r in runners)
    lat = sorted(r.finished_s - r.submitted_s for r in done)
    n = len(done)
    print(
        f"served {n} scenarios x {args.rollout_steps} rollout step(s) in "
        f"{dt:.3f}s ({n / dt:.2f} scen/s, warmup {warm_s:.2f}s excluded) "
        f"over {engine_steps} engine steps / {forwards} forwards; "
        f"latency p50 {lat[n // 2] * 1e3:.1f}ms p95 "
        f"{lat[min(n - 1, int(n * 0.95))] * 1e3:.1f}ms"
    )
    if runner.device.type == "cuda":
        print(f"spectral kernel launches: {launches} over {forwards} forwards{of_ranks}")
    if fleet is None and runner.cache is not None:
        s = runner.cache.stats
        lv = s["level_bytes"]
        print(
            f"geomodel cache: hit-rate {s['hit_rate']:.3f} "
            f"({s['hits']} hits / {s['misses']} misses, {s['entries']} "
            f"entries, {s['bytes'] / 1e6:.2f} MB, {s['evictions']} evicted, "
            f"{s['deep_evictions']} deep-evicted); level MB "
            + "/".join(f"{lv[k] / 1e6:.2f}" for k in lv)
            + f" ({'/'.join(lv)}); dedup attached {dedup_attached} follower(s)"
        )
    elif fleet is not None and fleet["cache_hits"] + fleet["cache_misses"]:
        print(
            f"fleet geomodel cache: hit-rate {fleet['cache_hit_rate']:.3f} "
            f"({fleet['cache_hits']} hits / {fleet['cache_misses']} misses across "
            f"{fleet['n_replicas']} replicas, {fleet['cache_bytes'] / 1e6:.2f} MB); "
            f"dedup attached {dedup_attached} follower(s)"
        )
    if runner.cache_store is not None:
        ss = runner.cache_store.stats
        print(
            f"cache store: {ss['hits']} hits / {ss['misses']} misses "
            f"({ss['hit_rate']:.3f}), {ss['puts']} puts, {ss['entries']} "
            f"entries, {ss['bytes'] / 1e6:.2f} MB"
        )

    if args.bench_sequential:
        seq_requests, _ = build_scenarios(
            cfg, args.scenarios, args.wells, args.seed, args.rollout_steps,
            n_static=n_static, dup=args.dup,
        )
        seq_done, seq_dt, seq_sched = serve(runner, seq_requests, 1, args.max_steps)
        check_served(seq_done, seq_requests, seq_sched.failed)
        print(
            f"sequential: {len(seq_done)} scenarios in {seq_dt:.3f}s "
            f"({len(seq_done) / seq_dt:.2f} scen/s); continuous batching "
            f"speedup {seq_dt / dt:.2f}x"
        )
    sys.stdout.flush()
    return done, dt


if __name__ == "__main__":
    main()
