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
import contextlib
import os
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
    flash_attention_cuda,
    flash_attention_ref,
    kernel_head_dim,
)
from repro_torch.kernels.flash_attention.ops import tma_alignment_error
from repro_torch.configs import SERVED_IDS, get_arch
from repro_torch.kernels.rmsnorm import ops as rms_ops
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
# rmsnorm: the launch plan and what the wrapper hands the C interface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan,d,itemsize,ok", [
    ((8, 2, 32, 4), 512, 2, True), ((8, 6, 64, 2), 3072, 2, True), ((1, 2, 64, 1), 100, 2, True),
    ((4, 2, 128, 1), 1024, 4, True), ((8, 0, 1024, 1), 40000, 2, True),
    ((8, 2, 32, 4), 100, 2, False),   # d no whole vectors
    ((4, 2, 32, 4), 512, 2, False),   # a vector not 16 bytes
    ((8, 9, 32, 1), 2304, 2, False),  # more vectors a thread than registers hold
    ((8, 2, 24, 4), 384, 2, False),   # threads a row neither a power of two nor whole warps
    ((8, 2, 48, 2), 768, 2, False),   # the same past a warp
    ((8, 2, 16, 1), 256, 2, False),   # a CTA of half a warp
    ((8, 2, 256, 4), 4096, 2, False),  # a CTA past MAX_BLOCK
    ((8, 1, 32, 1), 512, 2, False),   # the row not covered
    ((8, 0, 1000, 1), 40000, 2, False),  # two-pass kernel: not whole warps
    ((8, 0, 1024, 2), 40000, 2, False),  # two-pass kernel: one row a CTA
])
def test_plan_ok_mirrors_the_c_launcher(plan, d, itemsize, ok):
    """``ops.plan_ok``, which the A/B tool and these tests use, takes what
    ``rmsnorm_launch`` (csrc/rmsnorm.cu ``plan_ok``) takes and refuses what
    it refuses."""
    assert rms_ops.plan_ok(rms_ops.LaunchPlan(*plan), d, itemsize) is ok


def _served_norm_shapes():
    """(rows, d) of every RMSNorm the served configs run, for a decode step of
    1 and 4 slots and a 1000-token prefill: d_model, the q/k norms at head
    dim (rows: tokens x heads), MLA's kv_norm and the SSM's gated norm."""
    shapes = set()
    for name in SERVED_IDS:
        cfg = get_arch(name)
        for tokens in (1, 4, 1000):
            shapes.add((tokens, cfg.d_model))
            if cfg.qk_norm:
                shapes.add((tokens * cfg.n_heads, cfg.head_dim_))
                shapes.add((tokens * cfg.kv_heads, cfg.head_dim_))
            if cfg.mla is not None:
                shapes.add((tokens, cfg.mla.kv_lora))
            if cfg.ssm is not None:
                shapes.add((tokens, cfg.ssm.d_inner(cfg.d_model)))
    return sorted(shapes)


@pytest.mark.parametrize("rows,d", _served_norm_shapes())
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_launch_plan_of_every_served_norm(rows, d, dtype):
    """16-byte vectors, the row in registers, a plan the kernel takes; a CTA
    a row of at most two vectors a thread (more only in a CTA of the most
    threads) while the rows are fewer than the SMs, else at least as many CTAs as SMs, or the fewest rows a CTA that
    make whole warps."""
    itemsize = 2 if dtype == "bfloat16" else 4
    plan = rms_ops.launch_plan(rows, d, itemsize, True)
    assert plan.vec == 16 // itemsize and plan.nv >= 1
    assert rms_ops.plan_ok(plan, d, itemsize)
    assert (plan.nv - 1) * plan.tpr * plan.vec < d  # no thread left without a vector
    if rows < rms_ops.SMS:
        assert plan.tpr < 32 or plan.rpc == 1
        assert plan.nv <= rms_ops.DECODE_NV or plan.tpr == rms_ops.MAX_BLOCK
    else:
        assert -(-rows // plan.rpc) >= rms_ops.SMS or plan.rpc == max(1, 32 // plan.tpr)


@pytest.mark.parametrize("rows,d,itemsize,aligned", [
    (4, 100, 2, True), (1000, 102, 4, True), (1000, 3074, 2, True),  # d no whole vectors
    (4, 3072, 2, False), (1000, 1024, 4, False), (1, 8, 2, False),   # a pointer off 16 bytes
])
def test_launch_plan_takes_the_scalar_path(rows, d, itemsize, aligned):
    plan = rms_ops.launch_plan(rows, d, itemsize, aligned)
    assert plan.vec == 1 and rms_ops.plan_ok(plan, d, itemsize)


@pytest.mark.parametrize("d,itemsize,aligned", [(32768 + 8, 2, True), (16384 + 4, 4, True),
                                                (4096 + 1, 2, False)])
def test_launch_plan_sends_long_rows_to_the_two_pass_kernel(d, itemsize, aligned):
    plan = rms_ops.launch_plan(3, d, itemsize, aligned)
    assert plan.nv == 0 and rms_ops.plan_ok(plan, d, itemsize)
    assert rms_ops.launch_plan(3, d - (d % 8 or 8), itemsize, True).nv > 0


@pytest.mark.parametrize("rows", [1000, 4])
@pytest.mark.parametrize("d", [512, 1024, 2048, 2560, 3072])
def test_ab_tool_plans_are_plans_the_kernel_takes(rows, d):
    """``launch/ab_rmsnorm.py`` launches every candidate plan through the C
    interface: each must be one the launcher accepts, ``launch_plan``'s
    own first, none twice."""
    from repro_torch.launch.ab_rmsnorm import candidate_plans

    plans = candidate_plans(rows, d, 2)
    assert plans[0] == rms_ops.launch_plan(rows, d, 2, True) and len(set(plans)) == len(plans)
    assert all(rms_ops.plan_ok(p, d, 2) for p in plans)


@pytest.fixture
def rms_fake_card(monkeypatch):
    """Let ``rmsnorm_cuda`` run its host side on CPU tensors: a null raw
    stream, a current device that is x's (None for a CPU tensor) unless a
    test sets another, a device context that records its entries, and a
    launcher that records its arguments."""
    state = types.SimpleNamespace(current=None, entered=[], calls=[], err=0, sms=rms_ops.SMS)

    @contextlib.contextmanager
    def device(d):
        state.entered.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state.current)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    lib = types.SimpleNamespace(
        rmsnorm_launch=lambda *a: state.calls.append(a) or state.err,
        rmsnorm_error_string=lambda err: b"too many resources requested for launch")
    monkeypatch.setattr(rms_ops, "load_library", lambda: lib)
    monkeypatch.setattr(rms_ops, "sm_count", lambda index: state.sms)
    return state


@pytest.mark.parametrize("shape,dtype,sms", [((2, 500, 3072), torch.bfloat16, 132),
                                             ((2, 500, 3072), torch.bfloat16, 1000),
                                             ((4, 2048), torch.float32, 132),
                                             ((3, 100), torch.bfloat16, 132)])
def test_wrapper_passes_the_plan_and_sizes(rms_fake_card, shape, dtype, sms):
    """The plan is the one for the card's own SM count."""
    rms_fake_card.sms = sms
    x = torch.ones(shape, dtype=dtype)
    w = torch.ones(shape[-1])
    before = rmsnorm_cuda.launches
    y = rmsnorm_cuda(x, w, 1e-5)
    assert y.shape == x.shape and y.dtype == dtype and rmsnorm_cuda.launches == before + 1
    rows, d = x.numel() // shape[-1], shape[-1]
    aligned = (x.data_ptr() | w.data_ptr() | y.data_ptr()) % 16 == 0
    plan = rms_ops.launch_plan(rows, d, x.element_size(), aligned, sms)
    (call,) = rms_fake_card.calls
    assert call[:3] == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert call[3:5] == (rows, d) and call[5] == pytest.approx(1e-5)
    assert call[6:] == ({torch.bfloat16: 1, torch.float32: 0}[dtype], plan.vec, plan.nv,
                        plan.tpr, plan.rpc, 0)
    assert rms_fake_card.entered == []  # x on the current device: no device context


def test_wrapper_enters_the_device_only_off_the_current_one(rms_fake_card):
    x, w = torch.ones(4, 64), torch.ones(64)
    rms_fake_card.current = 1  # another device than x's
    rmsnorm_cuda(x, w, 1e-6)
    assert rms_fake_card.entered == [x.device.index] and len(rms_fake_card.calls) == 1


def test_wrapper_raises_on_a_failed_launch_and_counts_none(rms_fake_card):
    rms_fake_card.err = 701
    before = rmsnorm_cuda.launches
    with pytest.raises(RuntimeError, match="rmsnorm kernel launch failed: too many resources"):
        rmsnorm_cuda(torch.ones(4, 64), torch.ones(64), 1e-6)
    assert rmsnorm_cuda.launches == before


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
    # MLA's prefill (nope 128 + RoPE 64, v padded to 192) and the reduced MLA config's 24
    ("mla-d192-bf16", 1, 4, 4, 70, 70, 192, True, "bfloat16"),
    ("mla-reduced-d24", 1, 4, 4, 19, 19, 24, True, "float32"),
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


def test_kernel_head_dim_is_the_next_instance_and_refuses_past_256():
    """The wrapper runs a head dim at the smallest kernel instance at or
    above it (24, the reduced MLA config's, at 32, zero-padded) and refuses
    what no instance can take; a refused head dim raises before any launch."""
    assert KERNEL_HEAD_DIMS == (16, 32, 64, 128, 192, 256)
    want = {1: 16, 16: 16, 17: 32, 24: 32, 48: 64, 100: 128, 129: 192, 192: 192, 200: 256, 256: 256}
    assert {d: kernel_head_dim(d) for d in want} == want
    for bad in (0, 257, 320, 512):
        with pytest.raises(ValueError, match="head dim"):
            kernel_head_dim(bad)


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


def test_a_variant_whose_substitution_is_missing_raises_before_building():
    """``kernels.build.build_variants`` (the A/B tools' builder) checks every
    substitution against the source before it writes or compiles anything."""
    from repro_torch.kernels.spectral_conv.build import LIBRARY as SPECTRAL

    with pytest.raises(ValueError, match="not found"):
        build.build_variants(SPECTRAL.sources[0], {"bad": [("no such text", "")]}, "never_built")
    assert not os.path.exists(os.path.join(build.BUILD_DIR, "never_built_src"))


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


# every served width (kv_norm 512, mamba2 1024, v2-lite and mamba2's gated
# norm 2048, recurrentgemma 2560, gemma 3072) at 1, 4 and 1000 rows in both
# dtypes, and a d that is no whole number of 16-byte vectors
RMS_CARD_CASES = RMS_CASES + [
    (rows, d, dtype) for d in (512, 1024, 2048, 2560, 3072) for rows in (1, 4, 1000)
    for dtype in ("bfloat16", "float32") if (rows, d, dtype) not in RMS_CASES
] + [(4, 100, "bfloat16"), (1000, 100, "float32"), (37, 100, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", RMS_CARD_CASES)
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype):
    """The kernel vs its plain version on x as allocated and on a contiguous
    view of x offset by one element (not 16-byte aligned: the scalar path);
    a second launch on the same x agrees bitwise."""
    rng = np.random.default_rng(rows + d)
    flat = _torch(_np(rng, (rows * d + 1,), dtype)).to(cuda)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    for x in (flat[:-1].view(rows, d), flat[1:].view(rows, d)):
        before = rmsnorm_cuda.launches
        got = rmsnorm(x, w)
        again = rmsnorm(x, w)
        torch.cuda.synchronize()
        assert rmsnorm_cuda.launches == before + 2
        _close_to_plain(got, rmsnorm_ref(x, w), dtype)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,h,kvh,sq,sk,d,causal,dtype", FLASH_CASES + [
    ("gemma-prefill", 1, 16, 16, 1000, 1000, 256, True, "bfloat16"),
    ("chatglm3-gqa", 1, 32, 2, 777, 777, 128, True, "bfloat16"),
    ("f32-d256-ragged", 2, 2, 1, 65, 97, 256, True, "float32"),
    ("gemma-prefill-f32", 1, 16, 16, 1000, 1000, 256, True, "float32"),
    ("v2-lite-mla-prefill", 1, 16, 16, 1000, 1000, 192, True, "bfloat16"),
    ("v2-lite-mla-prefill-f32", 1, 16, 16, 1000, 1000, 192, True, "float32"),
    # recurrentgemma-2b's local attention: MQA, a group of 10 query heads
    ("recurrentgemma-mqa-prefill", 1, 10, 1, 1000, 1000, 256, True, "bfloat16"),
    ("recurrentgemma-mqa-prefill-f32", 1, 10, 1, 1000, 1000, 256, True, "float32"),
], ids=[c[0] for c in FLASH_CASES] + ["gemma-prefill", "chatglm3-gqa", "f32-d256-ragged",
                                      "gemma-prefill-f32", "v2-lite-mla-prefill",
                                      "v2-lite-mla-prefill-f32", "recurrentgemma-mqa-prefill",
                                      "recurrentgemma-mqa-prefill-f32"])
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
    q = torch.zeros(1, 2, 8, 320, device=cuda)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    assert flash_attention_cuda.launches == before


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
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS + (24,))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_every_head_dim(cuda, d, causal):
    """Every instance, and 24 (the reduced MLA config's) padded to 32: one
    launch either way."""
    rng = np.random.default_rng(d + causal)
    q, k, v = _bf16_qkv(rng, 1, 4, 2, 130, 193, d, cuda)
    if causal:
        q = q[:, :, :97]
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1 and got.shape == q.shape
    _close_to_plain(got, flash_attention_ref(q, k, v, causal=causal), "bfloat16")


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
