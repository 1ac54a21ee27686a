"""Public wrapper of the fused RMSNorm.

Port of ``repro.kernels.rmsnorm.ops``. The path is chosen by where the
tensor lies, and by nothing else: a CUDA tensor goes to the hand-written
kernel (``csrc/rmsnorm.cu``), a CPU tensor — which only a caller that asked
for the CPU has — to the plain version in ``ref``. A failed build or launch
raises; there is no fallback. Unlike the TPU wrapper, nothing is padded:
the kernel takes any number of rows and any width. How the kernel maps rows
onto threads is chosen here, by ``launch_plan``, and passed to it. Under
autograd the kernel's output is differentiable, with the plain version's
gradient (``rmsnorm_on_card``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import NamedTuple

import torch

from repro_torch.kernels.build import KernelLibrary, load
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

LIBRARY = KernelLibrary("repro_torch_rmsnorm", (
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "rmsnorm.cu"),
))
_TYPES = {torch.float32: 0, torch.bfloat16: 1}

# What the kernel takes (csrc/rmsnorm.cu): a CTA of at most MAX_BLOCK
# threads, each holding at most MAX_NV vectors of a row in registers; a row
# past that goes to the two-pass kernel, one CTA of LONG_BLOCK threads.
MAX_BLOCK, MAX_NV, LONG_BLOCK = 512, 8, 1024
# The plan's aims (from launch/ab_rmsnorm.py on an H100): while the rows are
# fewer than the card's SMs (a decode step), a CTA a row and DECODE_NV
# vectors a thread; else a row that fits a warp at DECODE_NV vectors a
# thread gets that, a row of at most PREFILL_NV * PREFILL_TPR vectors
# PREFILL_NV vectors a thread, a longer one PREFILL_TPR threads (more only
# past MAX_NV vectors each), and a CTA about PREFILL_BLOCK threads, as long
# as that leaves at least as many CTAs as the card has SMs: the wrapper
# passes its card's count; SMS, an H100's, is the count where none is given.
SMS = 132
DECODE_NV, PREFILL_NV, PREFILL_TPR, PREFILL_BLOCK = 2, 4, 64, 128


class LaunchPlan(NamedTuple):
    """How ``csrc/rmsnorm.cu`` maps rows onto threads: ``vec`` elements a
    vector (16 bytes' worth, or 1 on the scalar path), ``nv`` vectors a
    thread (0: the two-pass kernel of long rows), ``tpr`` threads a row and
    ``rpc`` rows a CTA; in the C launcher's order."""

    vec: int
    nv: int
    tpr: int
    rpc: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def threads_a_row(tpr: int) -> int:
    """``tpr`` rounded up to what the kernel maps onto warps: a power of two
    up to a warp, else whole warps."""
    return 1 << (tpr - 1).bit_length() if tpr <= 32 else 32 * _ceil_div(tpr, 32)


def plan_ok(plan: LaunchPlan, d: int, itemsize: int) -> bool:
    """Whether the C launcher (``plan_ok`` in csrc/rmsnorm.cu) takes ``plan``
    for rows of width ``d`` whose elements are ``itemsize`` bytes, the
    pointers aligned."""
    vec, nv, tpr, rpc = plan
    if vec not in (1, 16 // itemsize) or d % vec:
        return False
    if nv == 0:
        return rpc == 1 and tpr % 32 == 0 and tpr <= LONG_BLOCK
    if not 1 <= nv <= MAX_NV or tpr < 1 or rpc < 1 or threads_a_row(tpr) != tpr:
        return False
    return tpr * rpc <= MAX_BLOCK and tpr * rpc % 32 == 0 and nv * tpr * vec >= d


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, d: int, itemsize: int, aligned: bool, sms: int = SMS) -> LaunchPlan:
    """The kernel's plan for ``rows`` rows of width ``d`` whose elements are
    ``itemsize`` bytes on a card of ``sms`` SMs; ``aligned``: x, w and y all
    start on 16 bytes.

    16-byte vectors where the row is a whole number of them and the
    pointers allow, else the scalar path. Threads a row as the aims above
    say, rounded by ``threads_a_row``. Rows a CTA: about ``PREFILL_BLOCK``
    threads, halved while that leaves fewer CTAs than SMs, and never less
    than a warp."""
    vec = 16 // itemsize
    if not aligned or d % vec:
        vec = 1
    n_vec = d // vec
    if n_vec > MAX_NV * MAX_BLOCK:
        return LaunchPlan(vec, 0, LONG_BLOCK, 1)
    if rows < sms or n_vec <= 32 * DECODE_NV:
        tpr = _ceil_div(n_vec, DECODE_NV)
    elif n_vec <= PREFILL_NV * PREFILL_TPR:
        tpr = _ceil_div(n_vec, PREFILL_NV)
    else:
        tpr = max(PREFILL_TPR, _ceil_div(n_vec, MAX_NV))
    tpr = min(MAX_BLOCK, threads_a_row(tpr))
    nv = _ceil_div(n_vec, tpr)
    rpc = max(1, PREFILL_BLOCK // tpr) if rows >= sms else 1
    while rpc > 1 and _ceil_div(rows, rpc) < sms and (tpr * (rpc // 2)) % 32 == 0:
        rpc //= 2
    while (tpr * rpc) % 32:
        rpc *= 2
    return LaunchPlan(vec, nv, tpr, rpc)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = load(LIBRARY)
    lib.rmsnorm_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream (no synchronise) on a
    validated contiguous x [..., d] and f32 w [d], with ``launch_plan``'s
    plan. The host path is short, as thousands of these launch a served
    run: the stream is taken raw (``torch._C._cuda_getCurrentRawStream``,
    what PyTorch's own Triton launches use, not a ``Stream`` object), and
    x's device context is entered only when x is not on the current device.
    Counts its launches on ``rmsnorm_cuda.launches``."""
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    xp, wp, yp = x.data_ptr(), w.data_ptr(), y.data_ptr()
    index = x.device.index
    plan = launch_plan(rows, d, x.element_size(), (xp | wp | yp) % 16 == 0, sm_count(index))
    lib = load_library()
    current = index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(index):
        err = lib.rmsnorm_launch(xp, wp, yp, rows, d, eps, _TYPES[x.dtype], *plan,
                                 torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.rmsnorm_error_string(err).decode())
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0


class _RMSNorm(torch.autograd.Function):
    """The kernel's forward under autograd; the backward runs the plain
    version (``rmsnorm_ref``) again on the saved x and w and returns its
    gradient (f32 statistics, each gradient in its input's dtype),
    launching no kernel: the JAX package has no backward kernel either."""

    @staticmethod
    def forward(ctx, x, w, eps, launch):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return launch(x, w.float().contiguous(), eps)

    @staticmethod
    def backward(ctx, dy):
        want = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, want)]
            y = rmsnorm_ref(*ins, ctx.eps)
            grads = iter(torch.autograd.grad(y, [t for t in ins if t.requires_grad], dy))
        return tuple(next(grads) if n else None for n in want) + (None, None)


def rmsnorm_on_card(x: torch.Tensor, w: torch.Tensor, eps: float,
                    launch=rmsnorm_cuda) -> torch.Tensor:
    """``rmsnorm``'s path for a validated x on the card: ``launch`` (the
    kernel) on x and the f32 w, through an ``autograd.Function`` whose
    backward is the plain version's gradient when autograd records (grad
    mode on and x or w requires grad), else called as is."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps, launch)
    return launch(x, w.float().contiguous(), eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d] bf16 or f32; w: [d]. ``x * rsqrt(mean(x^2) + eps) * w``
    with f32 statistics, in x's dtype. Differentiable on both paths."""
    if x.dim() < 1 or tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"w shape {tuple(w.shape)} != ({x.shape[-1] if x.dim() else '?'},)")
    device = x.device
    if device != w.device:
        raise ValueError(f"x on {device}, w on {w.device}")
    if device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if x.dtype not in _TYPES:
        raise ValueError(f"x dtype {x.dtype} is not float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous for the CUDA kernel")
    if x.numel() == 0:
        return torch.empty_like(x)
    return rmsnorm_on_card(x, w, eps)
