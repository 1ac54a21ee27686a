"""Public wrapper of flash attention (forward).

Port of ``repro.kernels.flash_attention.ops.flash_attention`` on its
``use_pallas=True`` path. The path is chosen by where the tensors lie, and
by nothing else: CUDA tensors go to the hand-written kernel
(``csrc/flash_attention.cu``), CPU tensors — which only a caller that asked
for the CPU has — to the plain version in ``ref``. A failed build or launch
raises; there is no fallback. Unlike the TPU wrapper nothing is padded: the
kernel reads q, k and v through their (b, h, s) strides, so the strided
views that the attention layer hands over are read in place, and it masks
the ragged tails itself. The operands' dtype picks the kernel: bf16 runs on
the tensor cores with TMA loads, which need 16-byte aligned base pointers
and strides (``tma_alignment_error``); f32 runs the FFMA kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary, load
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LIBRARY = KernelLibrary("repro_torch_flash_attention", (
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "flash_attention.cu"),
))
HEAD_DIMS = (16, 32, 64, 128, 256)
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = load(LIBRARY)
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream (no synchronise) on
    validated operands; returns a contiguous [b, h, sq, d] in q's dtype.
    Counts its launches on ``flash_attention_cuda.launches``."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, kvh, sq, sk, d, strides, float(scale), int(causal), _TYPES[q.dtype], stream,
        )
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def tma_alignment_error(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the bf16 kernel's TMA loads cannot read ``t`` ([b, heads, s, d],
    unit stride along d), or None: its base address and the byte strides of
    its b, heads and s dims must be multiples of 16. A dim of extent 1 is
    never stepped over, so its stride does not count."""
    if t.data_ptr() % 16:
        return f"{name}'s base address is not 16-byte aligned"
    for dim in range(3):
        if t.shape[dim] > 1 and t.stride(dim) * t.element_size() % 16:
            return (f"{name}'s stride along dim {dim} is {t.stride(dim) * t.element_size()} "
                    f"bytes, not a multiple of 16")
    return None


def _validate(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} must be 4-D")
    b, h, sq, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{b}, kvh, sk, {d}]")
    kvh, sk = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    if causal and sq > sk:
        # the first sq - sk queries would see no key at all
        raise ValueError(f"causal attention needs sq <= sk, got sq={sq} sk={sk}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in _TYPES:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one of "
                         f"float32 or bfloat16 for all three")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [b, h, sq, d]; k/v: [b, kvh, sk, d] -> [b, h, sq, d] in q's dtype.

    f32 arithmetic inside; causal offset ``sk - sq`` on the true lengths;
    GQA maps query head i to kv head i // (h // kvh); ``scale`` defaults
    to d**-0.5. On the card d must be one of ``HEAD_DIMS``, each operand
    must have unit stride along d, and bf16 operands must pass
    ``tma_alignment_error``."""
    _validate(q, k, v, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} is not one of {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need unit stride along the head dim")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            reason = tma_alignment_error(name, t)
            if reason is not None:
                raise ValueError(f"the bf16 kernel's TMA loads need 16-byte alignment: {reason}")
    if q.numel() == 0:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
