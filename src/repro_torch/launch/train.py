"""Train the FNO surrogate, or a reduced LM, with checkpoints and restarts,
on one device or across ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --mode fno --steps 6 \
        --ckpt-dir CKPT [--x-store DS/x --y-store DS/y] [--device cpu] \
        [--devices N --model-shards P | PX PY] [--comm-chunks C] \
        [--online --out DS [--pde two_phase] [--datagen-backend process]]
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
        [--arch gemma-7b] --steps 6 --ckpt-dir CKPT [--devices N] [--device cpu]

The port of the reference's ``train.py --mode fno``: the same flags and
defaults, the same ``FNOConfig`` (modes ``max(2, g // 4)``, 4 blocks,
decoder 32), the same AdamW with a warm-up/cosine schedule, the same
loader schedule and normalization, the same fault supervisor, and the same
``fno_config.json`` beside the checkpoints, which the port's and the
reference's ``FNORunner`` both serve from. Every step is a forward, a
backward through the fused spectral op and an AdamW update (the CUDA
kernels on the card, their plain versions on the CPU). The port always
runs the fused op: ``--use-pallas`` is recorded in ``fno_config.json`` as
given, for serving.

``--devices N`` starts N ranks (``launch.mesh.launch_ranks``: gloo, all
on the card, or on the CPU with ``--device cpu``) laid out as (data x
model): ``--model-shards P`` shards each sample's x over P ranks (paper
Alg. 2), ``PX PY`` its x and y over PX x PY pencils, and the rest of the
ranks split the batch. Each rank reads only its shard of every batch,
keeps its shard of the spectral weights and, with ZeRO-1, its slice of
AdamW's moments; checkpoints hold the global state in the serial format.

``--online`` runs datagen (``launch/datagen.py``) in a background thread
of the launching process, once, and trains from the stores' complete
prefix while it writes (``data.loader.StreamingSchedule``): the stats
snapshot the run normalizes with goes to ``CKPT/stats_snapshot.json`` and
the watermark log to ``CKPT/watermarks.json`` (rank r > 0 of ``--devices
N`` logs to ``CKPT/watermarks.rank<r>.json``; rank 0 records each step's
watermark and broadcasts it, so every rank logs the same). The datagen
tasks simulate on the training device. Prints the reference's ``online:``
line after the ``done:`` line.

Without stores it trains on synthetic band-limited fields drawn from a
seeded ``torch.Generator`` (the reference draws its own with
``jax.random``; the two sides meet on stores). Prints ``done: steps=...
failures=... restores=... loss A -> B stragglers=...`` and, on the card,
the spectral kernels' launch counts (of rank 0, per rank). Runs on the
card unless ``--device`` names another device; with no card it raises.

``--mode lm`` is the reference's (``train.py:350-373``): ``reduced(arch)``
of ``--arch`` (a decoder; default gemma-7b) trained through ``lm_loss``
under the local policy (remat on) on the reference's tokens,
``np.random.default_rng(0)``'s (n_data, batch, 33) draw, step s taking
entry s % n_data; the params come from a seeded ``torch.Generator``.
``--devices N`` is data parallelism, as the reference's replicated
params make it: N ranks (gloo, sharing the card) each take their rows of
the batch under a data-only mesh policy (``launch.mesh.build_lm_groups``
with one rank to a model group), the gradients are averaged
(``reduce_grads``) and the moments split by ZeRO-1. An MoE arch's ranks
route their tokens together, as the reference's jit routes the whole
batch: the capacity is the global token count's and the load-balance loss
the global statistics' (``models/moe.py``). Prints the ``done:`` line,
``losses:`` with every step's loss, and on the card both LM kernels'
launch counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.configs import ENCDEC_IDS, get_arch, reduced
from repro_torch.core.fno import (
    FNOConfig, forward_and_specs, group_names, init_params, mse_loss, param_shapes,
)
from repro_torch.core.partition import shard_tree
from repro_torch.data.loader import NdArraySource, ShardedDatasetLoader, StreamingSchedule
from repro_torch.data.store import ArrayStore
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.spectral_conv import spectral_fused_cuda, spectral_fused_dw_cuda
from repro_torch.launch.mesh import build_fno_groups, build_lm_groups, fno_layout, launch_ranks
from repro_torch.models import LOCAL, ParallelPolicy, init_lm_params, lm_loss
from repro_torch.models.transformer import train_launches
from repro_torch.train.fault import FaultInjector, SupervisorResult, run_supervised
from repro_torch.train.optimizer import (
    AdamWConfig, init_opt_state, state_layout, warmup_cosine,
)
from repro_torch.train.train_loop import make_train_step

# How long a rank of ``--devices N`` waits in one collective for its peers
# before the launch fails (a hung or dead peer); the run itself has no
# wall-clock deadline, as the reference's has none.
RANK_TIMEOUT_S = 3600.0


def start_online_datagen(args, device):
    """Run ``run_datagen`` in a background thread (the paper's 'simulate
    in advance' cost removed: training overlaps it), its tasks on
    ``device``. Returns ``(thread, err_holder)``; the holder carries any
    datagen exception so the trainer fails loudly instead of stalling
    forever. Sets ``args.x_store``/``args.y_store`` from ``--out``."""
    from repro_torch.launch.datagen import build_parser, run_datagen

    if args.x_store:
        root = os.path.dirname(os.path.abspath(args.x_store))
        if (
            os.path.dirname(os.path.abspath(args.y_store or "")) != root
            or os.path.basename(os.path.abspath(args.x_store)) != "x"
            or os.path.basename(os.path.abspath(args.y_store)) != "y"
        ):
            raise SystemExit(
                "--online: stores must be <root>/x and <root>/y "
                "(datagen's layout); or pass --out <root> instead"
            )
    elif args.out:
        root = args.out
        args.x_store = os.path.join(root, "x")
        args.y_store = os.path.join(root, "y")
    else:
        raise SystemExit("--online needs --out (or --x-store/--y-store)")
    nx, ny, nz, nt = args.grid
    dg_args = build_parser().parse_args([
        "--pde", args.pde, "--n", str(args.n_data),
        "--grid", str(nx), str(ny), str(nz), "--nt", str(nt),
        "--out", root, "--backend", args.datagen_backend,
        "--workers", str(args.datagen_workers),
        "--chunks-xy", str(args.chunks_xy[0]), str(args.chunks_xy[1]),
        "--stats-every", str(max(1, min(args.batch, 4))),
        "--seed", str(args.seed), "--resume", "--device", str(device),
    ])
    err = []

    def _run():
        try:
            run_datagen(dg_args)
        except BaseException as e:  # noqa: BLE001 — re-raised by the waiters
            err.append(e)

    th = threading.Thread(target=_run, name="online-datagen", daemon=True)
    th.start()
    return th, err


def _wait_online(path: str, err: list, timeout: float, need_stats: bool) -> None:
    """Block until the store exists (and, if asked, carries normalization
    stats from the incremental Welford pass)."""
    deadline = time.monotonic() + timeout
    while True:
        if os.path.exists(os.path.join(path, "meta.json")):
            if not need_stats or "stats" in ArrayStore.open(path).meta:
                return
        if err:
            raise RuntimeError("online datagen failed") from err[0]
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"--online: store {path} "
                f"{'has no stats' if need_stats else 'never appeared'} "
                f"after {timeout}s"
            )
        time.sleep(0.05)


def _pin_online_stats(args, x_src) -> None:
    """Normalize with one stats snapshot for the whole run: datagen keeps
    rewriting meta.json's stats as samples land, so the first reader writes
    the stats it saw to ``CKPT/stats_snapshot.json`` and every later one
    (a rank, a restarted process) reads them from there."""
    snap = os.path.join(args.ckpt_dir, "stats_snapshot.json")
    if os.path.exists(snap):
        with open(snap) as f:
            x_src.meta["stats"] = json.load(f)
        return
    os.makedirs(args.ckpt_dir, exist_ok=True)
    tmp = snap + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(x_src.meta["stats"], f)
    os.rename(tmp, snap)


def synthetic_fno_data(cfg: FNOConfig, n: int, seed: int = 0):
    """Band-limited random fields (stand-in when no simulated store given):
    x standard normal, y = 0.5 tanh(roll(x, 1, x) + 0.5 roll(x, 2, y))."""
    g = torch.Generator().manual_seed(seed)
    nx, ny, nz, nt = cfg.grid
    x = torch.randn((n, cfg.in_channels, nx, ny, nz, nt), generator=g)
    y = torch.tanh(torch.roll(x, 1, dims=2) + 0.5 * torch.roll(x, 2, dims=3)) * 0.5
    return x.numpy(), y[:, : cfg.out_channels].numpy()


def write_fno_serving_config(ckpt_dir: str, cfg: FNOConfig, args, x_src, y_src,
                             normalized) -> None:
    """Persist the serving contract next to the checkpoints, with the
    reference's keys: architecture, model-shard layout and a snapshot of
    the normalization stats/kind the run trained with."""
    def stats_of(src):
        return (getattr(src, "meta", None) or {}).get("stats")

    def kind_of(src):
        return (getattr(src, "meta", None) or {}).get("normalizer", "meanstd")

    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "grid": list(cfg.grid),
        "modes": list(cfg.modes),
        "width": cfg.width,
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "n_blocks": cfg.n_blocks,
        "decoder_dim": cfg.decoder_dim,
        "model_shards": list(args.model_shards),
        "use_pallas": bool(args.use_pallas),
        "comm_chunks": cfg.comm_chunks,
        "normalized": list(normalized),
        "normalizer": kind_of(x_src),
        "x_stats": stats_of(x_src),
        "y_stats": stats_of(y_src),
    }
    tmp = os.path.join(ckpt_dir, f"fno_config.json.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.rename(tmp, os.path.join(ckpt_dir, "fno_config.json"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("fno", "lm"), default="fno")
    ap.add_argument("--arch", default="gemma-7b", help="lm mode: assigned arch id")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--inject-fault", type=int, default=None, help="fail once at this step")
    ap.add_argument("--x-store", default=None)
    ap.add_argument("--y-store", default=None)
    ap.add_argument("--online", action="store_true",
                    help="fno mode: spawn datagen in the background and "
                    "start training from the store's visible sample prefix "
                    "(Meyer-et-al streaming) instead of simulate-then-train")
    ap.add_argument("--out", default=None,
                    help="--online: dataset root (writes <out>/x, <out>/y); "
                    "alternative to --x-store/--y-store")
    ap.add_argument("--pde", choices=("two_phase", "navier_stokes"),
                    default="two_phase", help="--online: PDE to simulate")
    ap.add_argument("--datagen-workers", type=int, default=4)
    ap.add_argument("--datagen-backend", choices=("process", "thread"),
                    default="thread")
    ap.add_argument("--chunks-xy", type=int, nargs=2, default=(2, 2),
                    metavar=("CX", "CY"), help="--online: store chunking")
    ap.add_argument("--online-timeout", type=float, default=600.0,
                    help="--online: max seconds to wait for the simulator "
                    "(first samples, stats, per-step back-pressure)")
    ap.add_argument("--no-normalize", action="store_true",
                    help="skip input normalization from the store's stats")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the loader's background prefetch thread")
    ap.add_argument("--no-shuffle", action="store_true")
    ap.add_argument("--grid", type=int, nargs=4, default=(16, 16, 8, 8))
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--n-data", type=int, default=16)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-shards", type=int, nargs="+", default=[1],
                    help="model-parallel shards: one value P shards the solution "
                    "along x (paper Alg. 2); two values PX PY use the 2-D pencil "
                    "decomposition")
    ap.add_argument("--comm-chunks", type=int, default=1,
                    help="channel-chunk the distributed FFT pipelines: one "
                    "all-to-all per chunk (bit-identical)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="recorded in fno_config.json; the port always runs "
                    "the fused spectral op")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; 'cpu' "
                    "runs on the CPU)")
    return ap


def _refuse_unported(args) -> None:
    """Exit non-zero on flags that do not go together (the reference's
    words), and on what a later slice of the port brings."""
    if args.online and args.mode != "fno":
        raise SystemExit("--online is an fno-mode flag")
    if args.mode != "lm":
        return
    if args.arch in ENCDEC_IDS:
        raise SystemExit(f"--arch {args.arch}: --mode lm trains the decoder archs "
                         f"(the encoder-decoder family's loss is whisper_loss)")
    if args.batch % args.devices:
        raise SystemExit(f"--batch {args.batch} not divisible by --devices {args.devices}")


def _check_layout(args) -> None:
    """Exit with the reference's wording on a (data x model) layout that
    ``--devices``, ``--model-shards`` and ``--batch`` cannot make."""
    try:
        n_dp, _, n_model = fno_layout(args.devices, args.model_shards)
    except ValueError as e:  # library error -> CLI-flag wording
        raise SystemExit(f"--devices/--model-shards: {e}") from None
    if args.batch % n_dp:
        raise SystemExit(
            f"--batch {args.batch} not divisible by the data-parallel "
            f"size {n_dp} ({args.devices} devices / {n_model} model shards)"
        )


def _config_and_data(args):
    """(cfg, x_src, y_src, normalized) from the flags: the stores, or the
    synthetic fields, which every rank draws alike from the seed."""
    if bool(args.x_store) != bool(args.y_store):
        raise SystemExit("--x-store and --y-store must be given together")
    if args.x_store:
        x_src, y_src = ArrayStore.open(args.x_store), ArrayStore.open(args.y_store)
        grid = tuple(x_src.shape[-4:])
        in_ch, out_ch = x_src.shape[1], y_src.shape[1]
    else:
        x_src = y_src = None
        grid = tuple(args.grid)
        in_ch = out_ch = 1
    cfg = FNOConfig(
        grid=grid,
        modes=tuple(max(2, g // 4) for g in grid),
        width=args.width,
        in_channels=in_ch,
        out_channels=out_ch,
        n_blocks=4,
        decoder_dim=32,
        comm_chunks=args.comm_chunks,
    )
    if x_src is None:
        x_all, y_all = synthetic_fno_data(cfg, args.n_data)
        x_src, y_src = NdArraySource(x_all), NdArraySource(y_all)
    if args.online and not args.no_normalize:
        _pin_online_stats(args, x_src)
    return cfg, x_src, y_src, () if args.no_normalize else ("x",)


def train(args, device, world_size: int = 1) -> dict:
    """Run the supervised training of ``args`` on this rank (of
    ``world_size``, the rank's process group already joined when > 1) and
    return its summary: the supervisor's result and the kernel launches."""
    cfg, x_src, y_src, normalized = _config_and_data(args)
    groups = model = None
    if world_size > 1:
        data_group, model, _ = build_fno_groups(world_size, args.model_shards)
        groups = group_names(data_group, model)
    forward, x_part, p_parts = forward_and_specs(cfg, model)
    layout = None if groups is None else state_layout(groups, p_parts, param_shapes(cfg))
    opt_cfg = AdamWConfig(
        lr=warmup_cosine(args.lr, warmup=10, total=args.steps), weight_decay=0.0
    )

    def loss_fn(params, batch):
        return mse_loss(forward(params, batch["x"]), batch["y"]), {}

    step_fn = make_train_step(loss_fn, opt_cfg, grad_accum=args.grad_accum, layout=layout)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, generator=gen, device=device)
        if layout is not None:
            params = shard_tree(params, p_parts, groups)
        return {"params": params, "opt": init_opt_state(params, layout)}

    schedule, online = None, {}
    if args.online:
        # every rank draws each step from rank 0's watermark, agreed on the
        # training thread over a group of its own (never from the prefetch
        # thread, never interleaved with the step's collectives)
        group = dist.new_group(list(range(world_size))) if world_size > 1 else None
        rank = dist.get_rank() if world_size > 1 else 0
        log = "watermarks.json" if rank == 0 else f"watermarks.rank{rank}.json"
        schedule = StreamingSchedule([x_src, y_src], args.batch, seed=args.seed,
                                     timeout=args.online_timeout,
                                     log_path=os.path.join(args.ckpt_dir, log), group=group)
    executed = []

    def train_step(state, batch):
        if schedule is not None and "first_n_complete" not in online:
            # the moment the first step launches: how much of the dataset
            # exists? < n proves simulation and training truly overlap
            online["first_visible"] = schedule.visible_now()
            online["first_n_complete"] = x_src.n_complete()
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        executed.append(1)
        return {"params": params, "opt": opt}, metrics

    injector = FaultInjector([args.inject_fault]) if args.inject_fault is not None else None
    spectral_fused_cuda.launches = spectral_fused_dw_cuda.launches = 0
    loader = ShardedDatasetLoader(
        {"x": x_src, "y": y_src},
        args.batch,
        device=device,
        seed=args.seed,
        shuffle=not args.no_shuffle,
        normalize=normalized,
        prefetch=0 if args.no_prefetch else 2,
        part=None if layout is None else x_part,
        groups=groups,
        schedule=schedule,
    )

    def batches(step):
        if schedule is not None and schedule.group is not None:
            schedule.agree(step)
        return loader.batch(step)

    try:
        result = run_supervised(
            init_state=init_state,
            train_step=train_step,
            batch_iter=batches,
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            save_every=args.save_every,
            injector=injector,
            async_save=True,
            layout=layout,
        )
    finally:
        if schedule is not None:
            schedule.close()
        loader.close()
    if schedule is not None:
        online.update(schedule.metrics(), n_total=x_src.shape[0])
    return {"result": dataclasses.asdict(result), "executed": len(executed),
            "n_blocks": cfg.n_blocks, "fused": spectral_fused_cuda.launches,
            "dw": spectral_fused_dw_cuda.launches, "online": online}


def _train_rank(rank, world_size, device, args):
    """One rank of ``--devices N`` (run by ``launch_ranks``)."""
    return train(args, device, world_size)


def lm_tokens(vocab: int, n_data: int, batch: int) -> np.ndarray:
    """The reference's LM training tokens: (n_data, batch, 33) int32."""
    return np.random.default_rng(0).integers(0, vocab, size=(n_data, batch, 33), dtype=np.int32)


def train_lm(args, device, world_size: int = 1) -> dict:
    """``--mode lm`` on this rank (of ``world_size``, its process group
    already joined when > 1): the supervised training of ``reduced(arch)``;
    returns the supervisor's result and the LM kernels' launches."""
    cfg = reduced(get_arch(args.arch))
    tokens = lm_tokens(cfg.vocab, args.n_data, args.batch)
    rank = dist.get_rank() if world_size > 1 else 0
    local = args.batch // world_size
    opt_cfg = AdamWConfig(lr=warmup_cosine(args.lr, warmup=10, total=args.steps), weight_decay=0.0)

    def init_lm():
        return init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                              device=device)

    layout, policy = None, LOCAL
    if world_size > 1:
        groups = build_lm_groups(world_size, 1)
        policy = ParallelPolicy(mesh=groups)
        shapes = tree_map(lambda p: tuple(p.shape), init_lm())
        replicated = tree_map(lambda _: None, shapes)
        layout = state_layout(groups, replicated, shapes, grads_complete=True)

    def loss_fn(params, batch):
        return lm_loss(params, batch, cfg, policy)

    step_fn = make_train_step(loss_fn, opt_cfg, grad_accum=args.grad_accum, layout=layout)

    def init_state():
        params = init_lm()
        return {"params": params, "opt": init_opt_state(params, layout)}

    def batches(step):
        t = torch.from_numpy(tokens[step % args.n_data, rank * local:(rank + 1) * local])
        t = t.to(device=device, dtype=torch.long)
        return {"tokens": t[:, :-1], "targets": t[:, 1:]}

    executed = []

    def train_step(state, batch):
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        executed.append(1)
        return {"params": params, "opt": opt}, metrics

    rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
    result = run_supervised(
        init_state=init_state,
        train_step=train_step,
        batch_iter=batches,
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        save_every=args.save_every,
        injector=FaultInjector([args.inject_fault]) if args.inject_fault is not None else None,
        async_save=True,
        layout=layout,
    )
    return {"result": dataclasses.asdict(result), "executed": len(executed),
            "rmsnorm": rmsnorm_cuda.launches, "flash": flash_attention_cuda.launches,
            "per_pass": train_launches(cfg, tokens.shape[-1] - 1)}


def _train_lm_rank(rank, world_size, device, args):
    """One rank of ``--mode lm --devices N`` (run by ``launch_ranks``)."""
    return train_lm(args, device, world_size)


def _print_done(result: SupervisorResult) -> None:
    first = result.metrics_log[0][1]["loss"] if result.metrics_log else float("nan")
    last = result.metrics_log[-1][1]["loss"] if result.metrics_log else float("nan")
    print(
        f"done: steps={result.final_step} failures={result.failures} "
        f"restores={result.restores} loss {first:.3e} -> {last:.3e} "
        f"stragglers={len(result.straggler_steps)}"
    )


def main_lm(args, device):
    """``--mode lm``: train on one device, or on ``--devices`` ranks."""
    if args.devices == 1:
        out = train_lm(args, device)
    else:
        out = launch_ranks(_train_lm_rank, args.devices, tempfile.gettempdir(), args=(args,),
                           collective_timeout_s=RANK_TIMEOUT_S, device=device)[0]
    result = SupervisorResult(**out["result"])
    _print_done(result)
    print("losses: " + json.dumps([m["loss"] for _, m in result.metrics_log]))
    if device.type == "cuda":
        per = out["per_pass"]
        print(
            f"kernel launches: rmsnorm {out['rmsnorm']}, flash {out['flash']} over "
            f"{out['executed']} train steps x {args.grad_accum} micro-batches (a pass: rmsnorm "
            f"{per['rmsnorm']}, flash {per['flash']})"
            + (f" (rank 0 of {args.devices})" if args.devices > 1 else "")
        )
    return result


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if args.mode == "lm":
        return main_lm(args, resolve_device(args.device))
    _check_layout(args)
    device = resolve_device(args.device)
    dg_thread = dg_err = None
    if args.online:
        dg_thread, dg_err = start_online_datagen(args, device)
        _wait_online(args.x_store, dg_err, args.online_timeout, need_stats=not args.no_normalize)
        _wait_online(args.y_store, dg_err, args.online_timeout, need_stats=False)
    cfg, x_src, y_src, normalized = _config_and_data(args)
    write_fno_serving_config(args.ckpt_dir, cfg, args, x_src, y_src, normalized)
    if args.devices == 1:
        out = train(args, device)
    else:
        out = launch_ranks(_train_rank, args.devices, tempfile.gettempdir(), args=(args,),
                           collective_timeout_s=RANK_TIMEOUT_S, device=device)[0]
    if dg_thread is not None:
        dg_thread.join()  # let the simulator finish/flush before reporting
        if dg_err:
            raise RuntimeError("online datagen failed") from dg_err[0]
    result = SupervisorResult(**out["result"])
    _print_done(result)
    if device.type == "cuda":
        print(
            f"spectral kernel launches: fused {out['fused']}, "
            f"dw {out['dw']} over {out['executed']} train "
            f"steps x {out['n_blocks']} blocks x {args.grad_accum} micro-batches"
            + (f" (rank 0 of {args.devices})" if args.devices > 1 else "")
        )
    if args.online:
        on = out["online"]
        first = on.get("first_n_complete", "?")
        print(
            f"online: first step with {first}/{on['n_total']} samples complete "
            f"(visible={on.get('first_visible', '?')}) "
            f"stalls={on['stalls']} stall_s={on['stall_s']} "
            f"overlap={first != '?' and first < on['n_total']}"
        )
    return result


if __name__ == "__main__":
    main()
