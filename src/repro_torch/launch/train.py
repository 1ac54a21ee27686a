"""Train the FNO surrogate, with checkpoints and restarts, on one device or
across ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --mode fno --steps 6 \
        --ckpt-dir CKPT [--x-store DS/x --y-store DS/y] [--device cpu] \
        [--devices N --model-shards P | PX PY] [--comm-chunks C]

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

Without stores it trains on synthetic band-limited fields drawn from a
seeded ``torch.Generator`` (the reference draws its own with
``jax.random``; the two sides meet on stores). Prints ``done: steps=...
failures=... restores=... loss A -> B stragglers=...`` and, on the card,
the spectral kernels' launch counts (of rank 0, per rank). Runs on the
card unless ``--device`` names another device; with no card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.fno import (
    FNOConfig, forward_and_specs, group_names, init_params, mse_loss, param_shapes,
)
from repro_torch.core.partition import shard_tree
from repro_torch.data.loader import NdArraySource, ShardedDatasetLoader
from repro_torch.data.store import ArrayStore
from repro_torch.kernels.spectral_conv import spectral_fused_cuda, spectral_fused_dw_cuda
from repro_torch.launch.mesh import build_fno_groups, fno_layout, launch_ranks
from repro_torch.train.fault import FaultInjector, SupervisorResult, run_supervised
from repro_torch.train.optimizer import (
    AdamWConfig, init_opt_state, state_layout, warmup_cosine,
)
from repro_torch.train.train_loop import make_train_step

# How long a rank of ``--devices N`` waits in one collective for its peers
# before the launch fails (a hung or dead peer); the run itself has no
# wall-clock deadline, as the reference's has none.
RANK_TIMEOUT_S = 3600.0


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
                    help="train while datagen writes the stores (not ported yet)")
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
    """Exit non-zero on what a later slice of the port brings."""
    if args.mode == "lm":
        raise SystemExit("--mode lm is not ported yet (ROADMAP Queue 1 item 5, "
                         "the LLM family)")
    if args.online:
        raise SystemExit("--online is not ported yet (ROADMAP Queue 1 item 4, data)")


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

    executed = []

    def train_step(state, batch):
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
    )
    try:
        result = run_supervised(
            init_state=init_state,
            train_step=train_step,
            batch_iter=loader.batch,
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            save_every=args.save_every,
            injector=injector,
            async_save=True,
            layout=layout,
        )
    finally:
        loader.close()
    return {"result": dataclasses.asdict(result), "executed": len(executed),
            "n_blocks": cfg.n_blocks, "fused": spectral_fused_cuda.launches,
            "dw": spectral_fused_dw_cuda.launches}


def _train_rank(rank, world_size, device, args):
    """One rank of ``--devices N`` (run by ``launch_ranks``)."""
    return train(args, device, world_size)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    _check_layout(args)
    device = resolve_device(args.device)
    cfg, x_src, y_src, normalized = _config_and_data(args)
    write_fno_serving_config(args.ckpt_dir, cfg, args, x_src, y_src, normalized)
    if args.devices == 1:
        out = train(args, device)
    else:
        out = launch_ranks(_train_rank, args.devices, tempfile.gettempdir(), args=(args,),
                           collective_timeout_s=RANK_TIMEOUT_S, device=device)[0]
    result = SupervisorResult(**out["result"])
    first = result.metrics_log[0][1]["loss"] if result.metrics_log else float("nan")
    last = result.metrics_log[-1][1]["loss"] if result.metrics_log else float("nan")
    print(
        f"done: steps={result.final_step} failures={result.failures} "
        f"restores={result.restores} loss {first:.3e} -> {last:.3e} "
        f"stragglers={len(result.straggler_steps)}"
    )
    if device.type == "cuda":
        print(
            f"spectral kernel launches: fused {out['fused']}, "
            f"dw {out['dw']} over {out['executed']} train "
            f"steps x {out['n_blocks']} blocks x {args.grad_accum} micro-batches"
            + (f" (rank 0 of {args.devices})" if args.devices > 1 else "")
        )
    return result


if __name__ == "__main__":
    main()
