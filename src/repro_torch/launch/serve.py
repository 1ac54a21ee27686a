"""Batched LM serving CLI: the shared slot scheduler on a reduced arch.

Port of ``repro.launch.serve``: serves ``reduced(get_arch(--arch))`` with
random weights (seed 0) through ``Engine``, greedy decoding over
``--max-batch`` slots, prompts drawn as the reference draws them.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b

``--arch`` is any served config (``SERVED_IDS``: the dense family, the MoE
family, deepseek-moe-16b and deepseek-v2-lite-16b with MLA, and the
recurrent ones, mamba2-370m and recurrentgemma-2b); the encoder-decoder
whisper-tiny is refused, as the reference refuses it: it is served through
the ``whisper_*`` entry points (``repro_torch.models``). The default device is
the card (the hand-written RMSNorm and flash-attention kernels, built at
first use); there it also prints both kernels' launch counts
(``norms_per_forward`` RMSNorms per prefill or decode step, one flash
attention per attention layer per prefill: none for mamba2, one for the
reduced recurrentgemma, whose prompts here stay within its window).
``--device cpu`` runs their plain versions. Full width is served by
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.kernels import rmsnorm as rmsnorm_ops
from repro_torch.models import init_lm_params
from repro_torch.models.transformer import attention_layers, norms_per_forward
from repro_torch.serve import SERVABLE_FAMILIES, Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    if cfg.family not in SERVABLE_FAMILIES:
        # fail here, with the fix, instead of deep inside runner setup
        raise SystemExit(
            f"--arch {args.arch} (family {cfg.family!r}) is not servable by "
            f"the token engine; supported families: "
            f"{', '.join(SERVABLE_FAMILIES)}. Encoder-decoder archs are "
            f"served via the whisper_* entry points (repro_torch.models)."
        )
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"--arch {args.arch}: {exc}")
    if device.type == "cuda":
        # bf16 GEMMs accumulate in f32 and round once, as the reference's XLA ones
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        # build the kernels before the clock starts
        rmsnorm_ops.ops.load_library()
        flash_ops.ops.load_library()
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    engine = Engine(cfg, params, max_len=args.max_len, max_batch=args.max_batch, device=device)

    rng = np.random.default_rng(0)
    for r in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).tolist()
        engine.submit(Request(rid=r, prompt=prompt, max_tokens=args.max_tokens))

    rmsnorm_ops.rmsnorm_cuda.launches = flash_ops.flash_attention_cuda.launches = 0
    t0 = time.time()
    done = engine.run_until_done()
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(
        f"{args.arch}: served {len(done)} requests, {total_tokens} tokens in "
        f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {device}, "
        f"{engine.steps} scheduler steps (continuous batching over "
        f"{args.max_batch} slots)"
    )
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} -> {r.output}")
    if device.type == "cuda":
        runner = engine.runner
        prefills, steps = len(runner.prefill_s), len(runner.decode_s)
        # the prompts' 3-8 tokens are within any window: every attention
        # layer of every prefill runs flash
        print(
            f"kernel launches: rmsnorm {rmsnorm_ops.rmsnorm_cuda.launches} over "
            f"{prefills} prefills + {steps} decode steps x {norms_per_forward(cfg)} norms; "
            f"flash_attention {flash_ops.flash_attention_cuda.launches} over {prefills} "
            f"prefills x {attention_layers(cfg)} layers"
        )
    if engine.failed:
        raise SystemExit(f"{len(engine.failed)} requests failed: {engine.failed[0].error!r}")


if __name__ == "__main__":
    main()
