"""A/B of flash-attention kernel variants on the card, in one process.

    PYTHONPATH=src python -m repro_torch.launch.ab_flash

Each variant is ``csrc/flash_attention.cu`` with textual substitutions,
built as a library of its own under ``build/torch_ext/`` and launched
through the same C interface as the wrapper on the bf16 prefill shapes of
the LLM path (causal, q/k/v as the attention layer's strided views). It
prints, per shape, SDPA's device time and each variant's in turns (A B ...
then ... B A), with its max|d| against the plain version. The variants
measure what the kernel's parts cost; they are not kernels of the port:
"without p_lo" drops the second bf16 half of P from P . V (and fails the
bf16 gate), "__expf" takes the fast exponential. Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import torch

from repro_torch.kernels.build import BUILD_DIR, KernelLibrary, load
from repro_torch.kernels.flash_attention import LIBRARY, flash_attention_ref
from repro_torch.launch.profile_forward import busy_ms

VARIANTS = {
    "as committed": [],
    "without p_lo": [("      wgmma_rs(o, p_lo + 4 * kk, vd);\n", "")],
    "__expf": [("x = expf(x - (e < 2 ? mn0 : mn1));", "x = __expf(x - (e < 2 ? mn0 : mn1));")],
}
# (name, b, h, kvh, s, d): 1000-token prefills of gemma-7b, minitron-8b;
# chatglm3-6b's at 777 tokens
SHAPES = [("gemma-7b", 1, 16, 16, 1000, 256), ("chatglm3-6b", 1, 32, 2, 777, 128),
          ("minitron-8b", 1, 32, 8, 1000, 128)]


def build_variant(i: int, subs) -> ctypes.CDLL:
    text = open(LIBRARY.sources[0]).read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant substitution not found in the source: {old!r}")
        text = text.replace(old, new)
    src_dir = os.path.join(BUILD_DIR, "ab_flash_src", str(i))
    os.makedirs(src_dir, exist_ok=True)
    path = os.path.join(src_dir, "flash_attention.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = load(KernelLibrary(f"ab_flash_{i}", (path,)))
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def launch(lib, q, k, v) -> torch.Tensor:
    b, h, sq, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                                     k.shape[1], sq, k.shape[2], d, strides, d ** -0.5, 1, 1,
                                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return o


def device_ms(fn, n: int = 10) -> float:
    """Device time per call of ``fn``: the union of its kernels' spans in a
    ``torch.profiler`` trace of ``n`` calls, over ``n`` (the host's launch
    overhead outlasts a kernel of tens of microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        busy = busy_ms(trace, ("kernel",))
    if busy <= 0:
        raise SystemExit("the profiler trace held no kernel")
    return busy / n


def main() -> None:
    from torch.nn.attention.bias import causal_lower_right
    from torch.nn.functional import scaled_dot_product_attention

    if not torch.cuda.is_available():
        raise SystemExit("ab_flash needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = {name: build_variant(i, subs) for i, (name, subs) in enumerate(VARIANTS.items())}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, b, h, kvh, s, d in SHAPES:
        q, k, v = (torch.randn((b, s, n, d), device="cuda", generator=gen).bfloat16().transpose(1, 2)
                   for n in (h, kvh, kvh))
        ref = flash_attention_ref(q, k, v, causal=True).float()
        mask = causal_lower_right(s, s)
        sdpa = device_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              enable_gqa=True), n=10)
        runs = []
        for name in list(libs) + list(libs)[::-1]:
            err = float((launch(libs[name], q, k, v).float() - ref).abs().max())
            us = device_ms(lambda: launch(libs[name], q, k, v), n=10) * 1e3
            runs.append(f"{name} {us:.1f} us (max|d| {err:.2e})")
        print(f"[ab_flash] {tag} (b={b}, h={h}, kvh={kvh}, s={s}, d={d}): SDPA {sdpa * 1e3:.1f} us; "
              + "; ".join(runs) + f"; {gpu}", flush=True)


if __name__ == "__main__":
    main()
