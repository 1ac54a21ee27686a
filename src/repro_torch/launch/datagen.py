"""Cloud datagen CLI: BatchPool simulations -> chunked ArrayStore + stats.

The port of ``repro.launch.datagen``: the same flags, store layout, stats
and resume rules, on the port's simulators, cloud pool and store. One flag
more: ``--device`` (default: the card) names the device every task
simulates on; without a card the run raises unless given ``--device cpu``.
Process workers are spawned, one CPU thread each, and return numpy.

The paper's §V workflow, end to end: submit PDE simulations to the
clusterless batch pool (process workers standing in for Azure Batch VMs),
write every training pair into the chunked array store — spatially chunked
along x and y so each training shard later reads only its pencil — and
maintain a streaming Welford pass that merges each sample as it is written,
persisting per-channel normalization stats into the store's meta.json every
``--stats-every`` samples (so an online trainer can normalize long before
the dataset is finished; ``run_datagen`` is the library entry train.py's
``--online`` mode spawns in the background).

Writes are resumable and idempotent: chunk publishes are atomic, a sample
counts as done only when ALL its chunks exist, and a rerun simulates only
the missing samples (task args are derived deterministically from the
sample index, so a retry regenerates identical data).

    PYTHONPATH=src python -m repro_torch.launch.datagen \
        --pde two_phase --n 8 --grid 16 8 8 --nt 4 --out DS [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --mode fno \
        --x-store DS/x --y-store DS/y --devices 4 --model-shards 2 2
"""
from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

from repro_torch.cloud import BatchPool, LocalProcessBackend, ThreadBackend
from repro_torch.common.device import resolve_device
from repro_torch.data.pde.two_phase import geomodel_channel
from repro_torch.data.store import ArrayStore


# -- streaming normalization stats ------------------------------------------

def merge_welford(state, data: np.ndarray, axis) -> tuple:
    """Merge a data block into a running (count, mean, M2, absmax)
    per-channel state (Chan et al. parallel update, plus a running max|x|
    for the paper's normalize-by-max scheme) — one chunk in memory at a
    time."""
    n_b = int(np.prod([data.shape[a] for a in axis])) or 1
    mean_b = data.mean(axis=axis, dtype=np.float64)
    m2_b = ((data.astype(np.float64) - np.expand_dims(mean_b, axis)) ** 2).sum(axis=axis)
    amax_b = np.abs(data).max(axis=axis).astype(np.float64)
    if state is None:
        return n_b, mean_b, m2_b, amax_b
    n_a, mean_a, m2_a, amax_a = state
    n = n_a + n_b
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / n)
    m2 = m2_a + m2_b + delta ** 2 * (n_a * n_b / n)
    return n, mean, m2, np.maximum(amax_a, amax_b)


def merge_sample_welford(state, sample: np.ndarray) -> tuple:
    """Merge one full training sample ``[c, *spatial]`` into the running
    state — the unit of the incremental (write-time) stats pass."""
    block = sample[None]  # [1, c, *spatial]
    return merge_welford(state, block, (0,) + tuple(range(2, block.ndim)))


def accumulate_store_state(store: ArrayStore, samples=None) -> tuple:
    """(welford_state, n_samples) streamed chunk-wise over complete samples
    (all of them, or the explicit ``samples`` index list)."""
    state = None
    n_samples = 0
    rows = range(store.chunk_grid()[0]) if samples is None else samples
    for i in rows:
        if not store.sample_complete(i):
            continue
        n_samples += 1
        for idx in store.sample_chunk_indices(i):
            chunk = store.read_chunk(idx)
            # layout [1, c, *spatial]: reduce everything but the channel dim
            axis = (0,) + tuple(range(2, chunk.ndim))
            state = merge_welford(state, chunk, axis)
    return state, n_samples


def stats_from_state(state, n_samples: int) -> dict:
    count, mean, m2, amax = state
    std = np.sqrt(np.maximum(m2 / max(count - 1, 1), 0.0))
    return {
        "mean": [float(v) for v in np.atleast_1d(mean)],
        "std": [float(v) for v in np.atleast_1d(std)],
        "absmax": [float(v) for v in np.atleast_1d(amax)],
        "count": int(count),
        "n_samples": n_samples,
    }


def compute_store_stats(store: ArrayStore) -> dict:
    """Chunk-wise Welford over all complete samples -> per-channel stats.

    Reads each chunk exactly once and never materializes more than one chunk
    — the pass streams over blob storage just like training itself.
    """
    state, n_samples = accumulate_store_state(store)
    if state is None:
        raise RuntimeError(f"no complete samples in {store.root}")
    return stats_from_state(state, n_samples)


# -- task arg derivation (deterministic in sample index -> idempotent) -------

# The reference's task args, plus the device the task simulates on.

def two_phase_args(i: int, args) -> Tuple:
    return (args.seed + i, args.wells, tuple(args.grid), args.nt, args.device)


def navier_stokes_args(i: int, args) -> Tuple:
    rng = np.random.default_rng(np.random.SeedSequence([args.seed, i]))
    center = tuple(float(c) for c in rng.uniform(0.25, 0.75, size=3))
    return (center, args.grid[0], args.nt, args.device)


def to_training_pair(
    pde: str, result, nt: int, geomodel: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) in the FNO layout [c, nx, ny, nz, nt] (paper: the binary input
    map is repeated along t; the target is the full solution history).
    ``geomodel`` (two_phase) prepends the log-permeability field the sample
    was simulated on as a STATIC input channel (``geomodel_channel``: the
    same realization every two_phase sample was simulated on, which serving
    reuses for its UQ-ensemble scenarios)."""
    mask, field = result
    x = np.repeat(mask[None, :, :, :, None], nt, axis=-1).astype(np.float32)
    if geomodel:
        x = np.concatenate([geomodel_channel(mask.shape, nt), x], axis=0)
    return x, field[None].astype(np.float32)


def open_or_create(root: str, shape, chunks, resume: bool) -> ArrayStore:
    if resume and os.path.exists(os.path.join(root, "meta.json")):
        store = ArrayStore.open(root)
        if store.shape[1:] != tuple(shape[1:]) or store.chunks != tuple(chunks):
            raise SystemExit(
                f"--resume: existing store {root} has shape {store.shape} "
                f"chunks {store.chunks}, requested {tuple(shape)} / {tuple(chunks)}"
            )
        if store.shape[0] < shape[0]:
            # growing the dataset is just more independent chunk rows
            store.shape = tuple(shape)
            store.update_meta()
        return store
    if os.path.isdir(root):
        # ArrayStore.create would rewrite meta.json but leave old chunk
        # files behind, which then count as complete samples with STALE
        # data under the new meta — refuse rather than serve wrong samples.
        stale = [f for f in os.listdir(root) if f.startswith("c")]
        if stale:
            raise SystemExit(
                f"store {root} already holds {len(stale)} chunk file(s); "
                f"pass --resume to reuse them or delete the directory first"
            )
    return ArrayStore.create(root, shape, "f4", chunks)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pde", choices=("two_phase", "navier_stokes"), default="two_phase")
    ap.add_argument("--n", type=int, default=8, help="number of training samples")
    ap.add_argument("--grid", type=int, nargs=3, default=(16, 8, 8),
                    help="(nx, ny, nz); navier_stokes uses nx for all dims")
    ap.add_argument("--nt", type=int, default=4)
    ap.add_argument("--wells", type=int, default=2, help="two_phase: injectors/sample")
    ap.add_argument("--geomodel", action="store_true",
                    help="two_phase: prepend the shared log-permeability "
                    "geomodel as a static input channel (what the serving "
                    "geomodel cache keys on)")
    ap.add_argument("--out", required=True, help="dataset root; writes <out>/x, <out>/y")
    ap.add_argument("--chunks-xy", type=int, nargs=2, default=(2, 2), metavar=("CX", "CY"),
                    help="chunk counts along x/y (shard-aligned partial reads)")
    ap.add_argument("--backend", choices=("process", "thread"), default="process")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--vm-type", default="E8s_v3")
    ap.add_argument("--spot", action="store_true")
    ap.add_argument("--speculative", action="store_true",
                    help="re-execute stragglers (first finisher wins)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="skip samples whose chunks are already published")
    ap.add_argument("--no-stats", action="store_true")
    ap.add_argument("--normalizer", choices=("meanstd", "absmax"),
                    default="meanstd",
                    help="normalization kind persisted in meta.json and "
                    "honored by the loader and the serving runner "
                    "(absmax = the paper's normalize-targets-by-max)")
    ap.add_argument("--stats-every", type=int, default=4,
                    help="persist incremental Welford stats to meta.json "
                    "every K completed samples (online training reads them "
                    "before the dataset is finished)")
    ap.add_argument("--device", default=None,
                    help="device every task simulates on (default: cuda; "
                    "'cpu' runs on the CPU)")
    return ap


def main(argv=None):
    return run_datagen(build_parser().parse_args(argv))


def run_datagen(args) -> int:
    """Library-callable datagen body (``main`` minus argument parsing) —
    the entry point train.py's ``--online`` mode runs in the background."""
    args.device = str(resolve_device(args.device))
    if args.pde == "two_phase":
        from repro_torch.data.pde.two_phase import simulate_task
        nx, ny, nz = args.grid
        task_args = two_phase_args
    else:
        from repro_torch.data.pde.navier_stokes import simulate_task
        nx = ny = nz = args.grid[0]
        task_args = navier_stokes_args

    geomodel = bool(getattr(args, "geomodel", False))
    if geomodel and args.pde != "two_phase":
        raise SystemExit("--geomodel is a two_phase feature (permeability channel)")
    n_ch = 2 if geomodel else 1  # x only; the target is always 1 channel
    cx, cy = args.chunks_xy
    if nx % cx or ny % cy:
        raise SystemExit(f"grid ({nx},{ny}) not divisible by --chunks-xy ({cx},{cy})")
    chunks = (1, 1, nx // cx, ny // cy, nz, args.nt)
    x_shape = (args.n, n_ch, nx, ny, nz, args.nt)
    y_shape = (args.n, 1, nx, ny, nz, args.nt)
    xs = open_or_create(os.path.join(args.out, "x"), x_shape, chunks, args.resume)
    ys = open_or_create(os.path.join(args.out, "y"), y_shape, chunks, args.resume)

    # run-identity guard: task args are a pure function of (sample index,
    # pde, seed, ...), so --resume may only continue a run with the SAME
    # signature — otherwise kept samples would silently mix distributions
    gen_sig = {
        "pde": args.pde, "seed": args.seed, "nt": args.nt,
        "wells": args.wells if args.pde == "two_phase" else None,
        "geomodel": geomodel,
    }
    for store in (xs, ys):
        prev = store.meta.get("gen")
        if prev is not None:
            prev = {"geomodel": False, **prev}  # stores predating the flag
        if prev is not None and prev != gen_sig:
            raise SystemExit(
                f"store {store.root} was generated with {prev}, this run "
                f"asks for {gen_sig}; refusing to mix samples — use a "
                f"fresh --out (or matching --pde/--seed/--nt/--wells)"
            )
        if prev is None:
            store.update_meta(gen=gen_sig)
        # the kind is presentation (how stats are APPLIED), not data: safe
        # to (re)persist on every run, including --resume
        if store.meta.get("normalizer") != args.normalizer:
            store.update_meta(normalizer=args.normalizer)

    todo: List[int] = [
        i for i in range(args.n)
        if not (args.resume and xs.sample_complete(i) and ys.sample_complete(i))
    ]
    print(f"datagen: {args.n} samples requested, {args.n - len(todo)} already "
          f"complete, simulating {len(todo)} ({args.pde})")

    # incremental Welford: seed from samples already in the store (resume),
    # then merge each new sample as it is written, persisting to meta.json
    # every --stats-every samples so an ONLINE trainer sees normalization
    # stats long before the dataset is finished.
    track_stats = not args.no_stats
    stats_every = max(1, getattr(args, "stats_every", 4))
    state_x = state_y = None
    n_stat = 0
    if track_stats and todo and len(todo) < args.n:
        done_already = sorted(set(range(args.n)) - set(todo))
        state_x, n_stat = accumulate_store_state(xs, done_already)
        state_y, _ = accumulate_store_state(ys, done_already)

    def _persist_stats():
        if state_x is not None:
            xs.update_meta(stats=stats_from_state(state_x, n_stat))
        if state_y is not None:
            ys.update_meta(stats=stats_from_state(state_y, n_stat))

    if todo:
        backend = (
            LocalProcessBackend(args.workers) if args.backend == "process"
            else ThreadBackend(args.workers)
        )
        pool = BatchPool(
            backend,
            store_root=os.path.join(args.out, "blobs"),
            vm_type=args.vm_type,
            n_vms=args.workers,
            spot=args.spot,
        )
        try:
            if args.speculative:
                # straggler re-execution needs the full future set in flight
                results = pool.map(
                    simulate_task,
                    [task_args(i, args) for i in todo],
                    speculative=True,
                )
                pairs = zip(todo, results)
            else:
                # write each sample as its task resolves: a preempted run
                # keeps everything finished so far (--resume picks up the
                # rest), and only one result is in memory at a time
                futures = [
                    pool.submit(simulate_task, task_args(i, args)) for i in todo
                ]
                pairs = ((i, f.result()) for i, f in zip(todo, futures))
            for i, result in pairs:
                x, y = to_training_pair(args.pde, result, args.nt, geomodel)
                xs.write_sample(i, x)
                ys.write_sample(i, y)
                if track_stats:
                    state_x = merge_sample_welford(state_x, x)
                    state_y = merge_sample_welford(state_y, y)
                    n_stat += 1
                    if n_stat % stats_every == 0:
                        _persist_stats()
            rep = pool.cost_report()
            print(
                f"datagen: {rep['tasks']} tasks, mean {rep['mean_task_s']:.2f}s/task, "
                f"${rep['usd']:.4f} on {rep['vm_type']}"
                f"{' (spot)' if rep['spot'] else ''}, "
                f"speculated {rep['speculated']}"
            )
        finally:
            pool.shutdown()

    done = min(xs.n_complete(), ys.n_complete())
    print(f"datagen: {done}/{args.n} samples complete in {args.out}")
    if track_stats and done:
        if state_x is not None:
            _persist_stats()
        for name, store in (("x", xs), ("y", ys)):
            # a rerun with nothing to simulate keeps the persisted stats
            # bit-identical; otherwise fall back to the full streaming pass
            stats = store.meta.get("stats")
            if stats is None:
                stats = compute_store_stats(store)
                store.update_meta(stats=stats)
            print(
                f"stats[{name}]: mean {['%.4g' % m for m in stats['mean']]} "
                f"std {['%.4g' % s for s in stats['std']]} "
                f"({stats['n_samples']} samples)"
            )
    return done


if __name__ == "__main__":
    main()
