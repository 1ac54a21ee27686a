"""Serve the trained CO2 surrogate on one device: UQ-ensemble inference
through the slot scheduler.

Draws N permeability/well-placement scenarios the way the reference's
serving CLI does, serves them through ``FNORunner.from_checkpoint`` (the fused
CUDA spectral kernel on the card), and reports scenarios/s plus
per-request latency.

    PYTHONPATH=src python -m repro_torch.launch.serve_pde --ckpt-dir CKPT \
        --scenarios 8 --verify --bench-sequential

``CKPT`` is a directory written by the reference's ``train.py --mode fno``
(or by the port's ``train.checkpoint.save`` plus an ``fno_config.json``).
``--verify`` replays every served scenario through the port's unfused
plain forward on the same device and exits non-zero on a mismatch beyond
rtol=1e-4, atol=1e-5; ``--bench-sequential`` also serves the ensemble
one at a time over the same warm runner. ``--device cpu`` runs on the
CPU; the default is the card.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

MAX_STEPS = 10000


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


def serve(runner, requests, max_slots: int, max_steps: int = MAX_STEPS):
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
        raise SystemExit(f"served {len(done)}/{len(requests)} scenarios")


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True,
                    help="train.py --mode fno checkpoint directory")
    ap.add_argument("--scenarios", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4, help="scheduler slots")
    ap.add_argument("--rollout-steps", type=int, default=1,
                    help="autoregressive surrogate applications per scenario")
    ap.add_argument("--wells", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
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
    ap.add_argument("--dup", type=int, default=1,
                    help="submit each scenario this many times (identical "
                    "in-flight requests dedup onto one slot)")
    ap.add_argument("--verify", action="store_true",
                    help="check every served output against the unfused "
                    "plain forward (exit non-zero on mismatch)")
    ap.add_argument("--bench-sequential", action="store_true",
                    help="also serve one at a time and report the "
                    "continuous-batching speedup")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; 'cpu' "
                    "runs on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.serve import FNORunner

    n_static = args.static_channels if args.ensemble else 0
    try:
        runner = FNORunner.from_checkpoint(
            args.ckpt_dir,
            device=args.device,
            max_slots=args.max_batch,
            n_static=n_static,
            cache_bytes=args.cache_bytes,
            cache_level=args.cache_level,
        )
    except ValueError as e:  # library error -> CLI-flag wording
        raise SystemExit(f"--static-channels/--max-batch: {e}") from None
    cfg = runner.cfg
    print(
        f"serving {cfg.grid} FNO (width {cfg.width}, {cfg.n_blocks} blocks) "
        f"from step {runner.restored_step} on {runner.device} "
        f"(buckets {runner.buckets})"
    )
    warm_s = runner.warmup()

    requests, _ = build_scenarios(
        cfg, args.scenarios, args.wells, args.seed, args.rollout_steps,
        n_static=n_static, dup=args.dup,
    )
    spectral_fused_cuda.launches = 0
    done, dt, sched = serve(runner, requests, args.max_batch)
    launches = spectral_fused_cuda.launches
    check_served(done, requests, sched.failed)
    lat = sorted(r.finished_s - r.submitted_s for r in done)
    n = len(done)
    print(
        f"served {n} scenarios x {args.rollout_steps} rollout step(s) in "
        f"{dt:.3f}s ({n / dt:.2f} scen/s, warmup {warm_s:.2f}s excluded) "
        f"over {sched.steps} engine steps / {runner.batched_steps} forwards; "
        f"latency p50 {lat[n // 2] * 1e3:.1f}ms p95 "
        f"{lat[min(n - 1, int(n * 0.95))] * 1e3:.1f}ms"
    )
    if runner.device.type == "cuda":
        print(f"spectral kernel launches: {launches} over "
              f"{runner.batched_steps} forwards")
    if runner.cache is not None:
        s = runner.cache.stats
        lv = s["level_bytes"]
        print(
            f"geomodel cache: hit-rate {s['hit_rate']:.3f} "
            f"({s['hits']} hits / {s['misses']} misses, {s['entries']} "
            f"entries, {s['bytes'] / 1e6:.2f} MB, {s['evictions']} evicted, "
            f"{s['deep_evictions']} deep-evicted); level MB "
            + "/".join(f"{lv[k] / 1e6:.2f}" for k in lv)
            + f" ({'/'.join(lv)}); dedup attached {sched.dedup_attached} follower(s)"
        )

    if args.bench_sequential:
        seq_requests, _ = build_scenarios(
            cfg, args.scenarios, args.wells, args.seed, args.rollout_steps,
            n_static=n_static, dup=args.dup,
        )
        seq_done, seq_dt, seq_sched = serve(runner, seq_requests, 1)
        check_served(seq_done, seq_requests, seq_sched.failed)
        print(
            f"sequential: {len(seq_done)} scenarios in {seq_dt:.3f}s "
            f"({len(seq_done) / seq_dt:.2f} scen/s); continuous batching "
            f"speedup {seq_dt / dt:.2f}x"
        )

    if args.verify:
        worst = verify(runner, done, args.rollout_steps)
        print(f"verify OK: {n} scenarios match the unfused plain forward "
              f"(max abs diff {worst:.2e})")


if __name__ == "__main__":
    main()
