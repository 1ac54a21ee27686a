"""The bf16 logit gaps of a 48-layer mamba2 between the reference's two paths and the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/mamba2_bf16_gap.py --d-model 1024 --seeds 8
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/mamba2_bf16_gap.py --seeds 8
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/mamba2_bf16_gap.py --prompt 256 --seeds 4

Reduced mamba2-370m with mamba2's 48 layers (``--layers``) at bf16 and a
d_model of 64 (``--d-model``; 1024 is mamba2's own, about 6 GB here), the
parameters drawn with numpy as ``tests/test_torch_ssm.py`` draws them
(seed 10 + i, tokens seed 11 + i for i < ``--seeds``), a batch of 2
prompts. For each seed it prints max|d| / max|ref| of the prefill's
last-token logits and of one decode step's logits (fed the reference
kernel path's greedy token on every side) between: the reference with
``use_pallas=True`` (its RMSNorm kernel in interpret mode) and its plain
path; the port's plain path and each of them. The first is the
reference's own kernel-vs-plain gap that ``MAMBA2_BF16_GAP`` records
(``tests/test_torch_ssm.py``, ``chip_smoke.py``).
"""
import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.policy import LOCAL, ParallelPolicy  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import lm_decode_step, lm_params_from_numpy, lm_prefill  # noqa: E402
from test_torch_ssm import _f32, _jtree, _np_params, _tokens  # noqa: E402


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args(argv)
    s = args.prompt
    changes = dict(n_layers=args.layers, d_model=args.d_model, dtype="bfloat16")
    jcfg = dataclasses.replace(jreduced(jget_arch("mamba2-370m")), **changes)
    cfg = dataclasses.replace(reduced(get_arch("mamba2-370m")), **changes)
    worst = 0.0
    for seed in range(args.seeds):
        tree, tokens = _np_params(jcfg, 10 + seed), _tokens(11 + seed, 2, s, cfg.vocab)
        out, tok = {}, None
        for name, policy in (("kernel", ParallelPolicy(use_pallas=True)), ("plain", LOCAL)):
            logits, cache = jax.jit(
                lambda p, t: jtf.lm_prefill(p, t, jcfg, policy, max_len=s + 1))(_jtree(tree), tokens)
            if tok is None:
                tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            step, _ = jax.jit(
                lambda p, t, c: jtf.lm_decode_step(p, t, c, jnp.int32(s), jcfg, policy))(
                _jtree(tree), tok, cache)
            out[name] = (_f32(logits), _f32(step))
        params = lm_params_from_numpy(tree, device="cpu")
        with torch.inference_mode():
            logits, cache = lm_prefill(params, torch.from_numpy(tokens).long(), cfg, max_len=s + 1)
            step, _ = lm_decode_step(params, torch.from_numpy(np.array(tok)).long(), cache, s, cfg)
        out["port"] = (_f32(logits), _f32(step))
        gaps = {pair: [_rel(out[pair[0]][i], out[pair[1]][i]) for i in (0, 1)]
                for pair in (("kernel", "plain"), ("port", "kernel"), ("port", "plain"))}
        worst = max(worst, *gaps["kernel", "plain"])
        print(f"layers {args.layers} d_model {args.d_model} prompt {s} seed {seed}: " + "; ".join(
            f"{a} vs {b}: prefill {g[0]:.4e}, decode {g[1]:.4e}" for (a, b), g in gaps.items()),
            flush=True)
    print(f"the reference's kernel-vs-plain gap, worst over {args.seeds} seeds: {worst:.4e}")


if __name__ == "__main__":
    main()
