"""The port's RMSNorm and flash-attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions; these are held
against the reference's TPU kernels (``rmsnorm_pallas``,
``flash_attention_pallas``) run through their wrappers with
``use_pallas=True``, which puts them in interpret mode here. Inputs come
from numpy seeds. Gates, as in ``tests/test_kernels.py``: rtol = atol =
1e-5 for float32 and 2e-2 for bfloat16 (one rounding of the output to
bf16 is 2^-8 relative).

The ``cuda``-marked tests hold the hand-written kernels against the plain
versions on the card, both of which compute in float32 and round once:
float32 within 1e-5, bfloat16 within one output rounding (2^-7 |ref|) plus
1e-3 max|ref| for values near zero. They skip without a card and run there
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_kernels.py
"""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_cuda,
    flash_attention_ref,
)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cuda, rmsnorm_ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_ULP = 2.0 ** -7  # one bf16 rounding, relative to the rounded value
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm: the port's plain version vs rmsnorm_pallas (interpret mode)
# ---------------------------------------------------------------------------

RMS_CASES = [
    (1, 8, "float32"),
    (1, 3072, "bfloat16"),
    (4, 3072, "float32"),
    (37, 96, "bfloat16"),
    (256, 96, "float32"),
    (300, 8, "bfloat16"),
    (300, 3072, "float32"),
    (300, 3072, "bfloat16"),
]


@pytest.mark.parametrize("rows,d,dtype", RMS_CASES)
def test_rmsnorm_plain_matches_pallas(rows, d, dtype):
    rng = np.random.default_rng(rows * 7 + d)
    x = _np(rng, (rows, d), dtype, scale=3.0)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    want = jrmsnorm(jnp.asarray(x), jnp.asarray(w), use_pallas=True)
    before = rmsnorm_cuda.launches
    got = rmsnorm(_torch(x), torch.from_numpy(w))
    assert rmsnorm_cuda.launches == before  # CPU tensors never reach the kernel
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (rows, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_rmsnorm_keeps_leading_dims_and_eps():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32) * 1e-3
    w = rng.standard_normal(16).astype(np.float32)
    want = jrmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-5, use_pallas=True, block_rows=8)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5)
    assert tuple(got.shape) == (2, 3, 16)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_rmsnorm_rejects_a_weight_of_the_wrong_width():
    with pytest.raises(ValueError, match="w shape"):
        rmsnorm(torch.ones(3, 8), torch.ones(7))


# ---------------------------------------------------------------------------
# flash attention: the port's plain version vs flash_attention_pallas
# ---------------------------------------------------------------------------

# (name, b, h, kvh, sq, sk, d, causal, dtype)
FLASH_CASES = [
    ("mha-causal", 2, 4, 4, 100, 100, 32, True, "float32"),
    ("gqa-ragged-bf16", 1, 8, 2, 130, 130, 64, True, "bfloat16"),
    ("mqa-sq<sk", 1, 4, 1, 50, 200, 16, True, "float32"),
    ("noncausal-cross", 2, 2, 2, 64, 192, 128, False, "float32"),
    ("d256-causal-bf16", 1, 2, 2, 140, 140, 256, True, "bfloat16"),
    ("d256-gqa-sq<sk", 1, 4, 2, 33, 129, 256, True, "float32"),
    ("mqa-noncausal-bf16", 1, 4, 1, 70, 70, 128, False, "bfloat16"),
]


@pytest.mark.parametrize("name,b,h,kvh,sq,sk,d,causal,dtype", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_pallas(name, b, h, kvh, sq, sk, d, causal, dtype):
    rng = np.random.default_rng(len(name) + d)
    q = _np(rng, (b, h, sq, d), dtype)
    k = _np(rng, (b, kvh, sk, d), dtype)
    v = _np(rng, (b, kvh, sk, d), dtype)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, use_pallas=True)
    before = flash_attention_cuda.launches
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=causal)
    assert flash_attention_cuda.launches == before
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (b, h, sq, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_reads_strided_views_and_an_explicit_scale():
    """The layer hands over swapaxes views; a scale other than d^-0.5."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 40, 4, 16)).astype(np.float32)   # [b, s, h, d]
    k = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    assert not tq.is_contiguous()
    want = jflash(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)), causal=True,
                  scale=0.3, use_pallas=True)
    got = flash_attention(tq, tk, tv, causal=True, scale=0.3)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes,causal,match", [
    (((1, 4, 9, 16), (1, 4, 8, 16)), True, "sq <= sk"),
    (((1, 4, 8, 16), (1, 3, 8, 16)), True, "multiple of kv heads"),
    (((1, 4, 8, 16), (1, 4, 8, 32)), False, "must be"),
])
def test_flash_rejects_what_it_cannot_compute(shapes, causal, match):
    qs, ks = shapes
    with pytest.raises(ValueError, match=match):
        flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks), causal=causal)


def test_flash_rejects_mixed_dtypes():
    q = torch.zeros(1, 2, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q, q.float(), q.float())


# ---------------------------------------------------------------------------
# the shared build loader
# ---------------------------------------------------------------------------

def test_each_library_builds_in_its_own_directory():
    from repro_torch.kernels.flash_attention.ops import LIBRARY as FLASH
    from repro_torch.kernels.rmsnorm.ops import LIBRARY as RMS
    from repro_torch.kernels.spectral_conv.build import LIBRARY as SPECTRAL

    libs = (SPECTRAL, RMS, FLASH)
    dirs = {lib.build_directory for lib in libs}
    assert len(dirs) == 3 and all(os.path.dirname(d) == build.BUILD_DIR for d in dirs)
    assert all(os.path.isfile(src) and src.endswith(".cu") for lib in libs for src in lib.sources)


def test_build_without_a_compiler_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    lib = build.KernelLibrary("never_built", (os.path.abspath(__file__),))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build([lib])


# ---------------------------------------------------------------------------
# on the card: the kernels vs their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close_to_plain(got, want, dtype):
    g, r = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(g, r, rtol=TOL[dtype], atol=TOL[dtype])
        return
    excess = (g - r).abs() - (BF16_ULP * r.abs() + 1e-3 * r.abs().max())
    assert float(excess.max()) <= 0, f"max|d| {float((g - r).abs().max()):.3e} past the bf16 gate"


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", RMS_CASES + [(1000, 3072, "bfloat16")])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = _torch(_np(rng, (rows, d), dtype)).to(cuda)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    before = rmsnorm_cuda.launches
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    _close_to_plain(got, rmsnorm_ref(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,h,kvh,sq,sk,d,causal,dtype", FLASH_CASES + [
    ("gemma-prefill", 1, 16, 16, 1000, 1000, 256, True, "bfloat16"),
    ("chatglm3-gqa", 1, 32, 2, 777, 777, 128, True, "bfloat16"),
    ("f32-d256-ragged", 2, 2, 1, 65, 97, 256, True, "float32"),
    ("gemma-prefill-f32", 1, 16, 16, 1000, 1000, 256, True, "float32"),
], ids=[c[0] for c in FLASH_CASES] + ["gemma-prefill", "chatglm3-gqa", "f32-d256-ragged",
                                      "gemma-prefill-f32"])
def test_flash_kernel_matches_plain(cuda, name, b, h, kvh, sq, sk, d, causal, dtype):
    rng = np.random.default_rng(len(name) + d)
    # [b, s, h, d] tensors swapped to [b, h, s, d], as the attention layer does
    q = _torch(_np(rng, (b, sq, h, d), dtype)).to(cuda).transpose(1, 2)
    k = _torch(_np(rng, (b, sk, kvh, d), dtype)).to(cuda).transpose(1, 2)
    v = _torch(_np(rng, (b, sk, kvh, d), dtype)).to(cuda).transpose(1, 2)
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    _close_to_plain(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x.t(), torch.ones(4, device=cuda))
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
