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
    HEAD_DIMS,
    flash_attention,
    flash_attention_cuda,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.ops import tma_alignment_error
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


def test_tma_alignment_error_names_what_the_bf16_kernel_cannot_load():
    """The bf16 kernel's TMA loads need 16-byte aligned base pointers and
    (b, heads, s) strides; a dim of extent 1 does not count. The check is
    pure index arithmetic, so it is held here on CPU tensors."""
    base = torch.zeros(2, 3, 8, 72, dtype=torch.bfloat16)
    assert tma_alignment_error("q", base[..., :64]) is None  # rows of 144 bytes
    assert tma_alignment_error("q", base.transpose(1, 2)) is None
    assert "base address" in tma_alignment_error("q", base[..., 1:65])
    odd = torch.zeros(2, 3, 8, 68, dtype=torch.bfloat16)[..., :64]  # rows of 136 bytes
    assert "dim 2" in tma_alignment_error("k", odd)
    one_row = torch.zeros(2 * 3 * 64, dtype=torch.bfloat16).as_strided((2, 3, 1, 64), (192, 64, 3, 1))
    assert tma_alignment_error("v", one_row) is None  # the row stride is never stepped
    # f32 operands and CPU tensors never reach the bf16 kernel
    assert flash_attention(base[..., 1:17], base[..., 1:17], base[..., 1:17]).shape == (2, 3, 8, 16)


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


def test_flash_variants_of_the_ab_tool_apply_to_the_source():
    """``launch/ab_flash.py`` builds its variants by textual substitution in
    ``flash_attention.cu``; each substitution must still find its text."""
    from repro_torch.kernels.flash_attention.ops import LIBRARY as FLASH
    from repro_torch.launch.ab_flash import VARIANTS

    with open(FLASH.sources[0]) as f:
        text = f.read()
    for name, subs in VARIANTS.items():
        for old, _ in subs:
            assert text.count(old) == 1, (name, old)


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


# the bf16 kernel's edges: q tiles of 64 rows and K/V tiles of 64 keys
# (sq, sk, causal): both lengths at 1, 63, 64, 65, 127, 129 and 1000,
# causal with sq < sk, non-causal with sq > sk
BF16_EDGES = [(n, n, True) for n in (1, 63, 64, 65, 127, 129, 1000)] + [
    (1, 64, True), (63, 129, True), (65, 1000, True), (127, 129, False), (1000, 63, False),
    (64, 1, False), (129, 65, False)]


def _bf16_qkv(rng, b, h, kvh, sq, sk, d, dev):
    """[b, s, heads, d] bf16 tensors swapped to [b, heads, s, d], as the
    attention layer hands them over."""
    return [_torch(_np(rng, (b, s, n, d), "bfloat16")).to(dev).transpose(1, 2)
            for s, n in ((sq, h), (sk, kvh), (sk, kvh))]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,causal", BF16_EDGES)
def test_flash_bf16_kernel_at_tile_edges(cuda, sq, sk, causal):
    rng = np.random.default_rng(sq * 7 + sk)
    q, k, v = _bf16_qkv(rng, 2, 4, 2, sq, sk, 128, cuda)
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    _close_to_plain(got, flash_attention_ref(q, k, v, causal=causal), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_every_head_dim(cuda, d, causal):
    rng = np.random.default_rng(d + causal)
    q, k, v = _bf16_qkv(rng, 1, 4, 2, 130, 193, d, cuda)
    if causal:
        q = q[:, :, :97]
    _close_to_plain(flash_attention(q, k, v, causal=causal),
                    flash_attention_ref(q, k, v, causal=causal), "bfloat16")


@pytest.mark.cuda
def test_flash_bf16_kernel_gqa_group_16_and_repeatable(cuda):
    """chatglm3-6b's grouping (32 query heads on 2 kv heads); two runs agree
    bitwise (no atomics, no split over keys)."""
    rng = np.random.default_rng(16)
    q, k, v = _bf16_qkv(rng, 1, 32, 2, 777, 777, 128, cuda)
    got = flash_attention(q, k, v, causal=True)
    again = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close_to_plain(got, flash_attention_ref(q, k, v, causal=True), "bfloat16")


@pytest.mark.cuda
def test_flash_bf16_rejects_misaligned_views(cuda):
    base = torch.zeros(1, 2, 8, 72, dtype=torch.bfloat16, device=cuda)
    ok = base[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(base[..., 1:65], ok, ok)
    odd = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(ok, odd, ok)
    before = flash_attention_cuda.launches
    flash_attention(ok, ok, ok)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
