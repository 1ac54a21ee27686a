"""The port's flattened-K spectral op ``spectral_apply`` vs the JAX reference,
on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its public op with the Pallas kernels ``spectral_apply_pallas``
and ``spectral_dw_pallas`` in interpret mode (``use_pallas=True`` off a
TPU), with a ``block_k`` that does not divide K where the case says so; the
port's CPU path is its plain version. Gradients are compared in torch's
convention: JAX's cotangent of a complex input is the conjugate of torch's
``.grad``. Gate: rtol=1e-4, atol=1e-5 (float32 sums in another order).
The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spectral_conv import spectral_apply as jax_apply
from repro.kernels.spectral_conv import spectral_apply_ref as jax_apply_ref
from repro.kernels.spectral_conv.kernel import spectral_dw_pallas
from repro_torch.kernels.spectral_conv import (
    ops,
    spectral_apply,
    spectral_apply_cuda,
    spectral_apply_dw,
    spectral_apply_dx,
    spectral_apply_ref,
    spectral_dw_cuda,
)

RTOL, ATOL = 1e-4, 1e-5


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# (b, ci, co, modes, block_k): the reference's own shapes
# (tests/test_kernels.py) and K not divisible by block_k, over 2-4 mode dims
CASES = [
    (1, 4, 4, (2, 2, 2, 2), 8),
    (2, 6, 5, (4, 4, 2, 3), 8),
    (3, 8, 8, (3, 5, 1, 2), 8),   # K=30, padded to 32
    (2, 3, 4, (5, 3), 7),         # K=15
    (1, 5, 3, (3, 4, 5), 16),     # K=60
    (3, 2, 7, (6, 5), 4),         # K=30
]
IDS = [f"b{c[0]}-ci{c[1]}-co{c[2]}-m{'x'.join(map(str, c[3]))}-bk{c[4]}" for c in CASES]


def _channels_outermost(t: torch.Tensor) -> torch.Tensor:
    """The same values with the channel dim outermost in memory."""
    return t.transpose(0, 1).contiguous().transpose(0, 1)


@pytest.mark.parametrize("b,ci,co,modes,block_k", CASES, ids=IDS)
def test_forward_matches_jax_pallas(b, ci, co, modes, block_k):
    rng = np.random.default_rng(sum(modes) + 10 * b)
    xf, w = _cplx(rng, (b, ci) + modes), _cplx(rng, (ci, co) + modes)
    pallas = np.asarray(jax_apply(jnp.asarray(xf), jnp.asarray(w), use_pallas=True,
                                  block_k=block_k, interpret=True))
    oracle = np.asarray(jax_apply_ref(jnp.asarray(xf), jnp.asarray(w)))
    xt, wt = torch.from_numpy(xf), torch.from_numpy(w)
    for x_, w_ in ((xt, wt), (_channels_outermost(xt), _channels_outermost(wt))):
        got = spectral_apply(x_, w_).numpy()
        assert got.shape == (b, co) + modes and got.dtype == np.complex64
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def _k_leading(z: np.ndarray, block_k: int) -> np.ndarray:
    """[n, c, *modes] -> [K padded to block_k, n, c], as the TPU wrapper
    lays its operands out."""
    n, c = z.shape[:2]
    z2 = np.moveaxis(z.reshape(n, c, -1), -1, 0)
    return np.pad(z2, ((0, (-z2.shape[0]) % block_k), (0, 0), (0, 0)))


@pytest.mark.parametrize("b,ci,co,modes,block_k", CASES, ids=IDS)
def test_dw_matches_jax_pallas_conjugated(b, ci, co, modes, block_k):
    """The port's weight cotangent (torch's convention) is the conjugate of
    JAX's Pallas ``spectral_dw_pallas`` fed the conjugate cotangent."""
    rng = np.random.default_rng(sum(modes) + 10 * b + 1)
    xf, g = _cplx(rng, (b, ci) + modes), _cplx(rng, (b, co) + modes)
    x2, g2 = _k_leading(xf, block_k), _k_leading(np.conj(g), block_k)
    wr, wi = spectral_dw_pallas(
        jnp.asarray(x2.real), jnp.asarray(x2.imag),
        jnp.asarray(g2.real), jnp.asarray(g2.imag),
        block_k=block_k, interpret=True,
    )
    k = int(np.prod(modes))
    jax_dw = np.moveaxis((np.asarray(wr) + 1j * np.asarray(wi))[:k], 0, -1).reshape((ci, co) + modes)
    got = spectral_apply_dw(torch.from_numpy(xf), torch.from_numpy(g)).numpy()
    assert got.shape == (ci, co) + modes and got.dtype == np.complex64
    np.testing.assert_allclose(got, np.conj(jax_dw), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,ci,co,modes,block_k", CASES, ids=IDS)
def test_grads_match_jax_vjp(b, ci, co, modes, block_k):
    """``.grad`` of sum(|y|^2) through the port's autograd Function equals
    conj(``jax.grad``) through the reference's custom_vjp on the Pallas
    kernels, for x and w."""
    rng = np.random.default_rng(sum(modes) + 10 * b + 2)
    xf, w = _cplx(rng, (b, ci) + modes), _cplx(rng, (ci, co) + modes)

    def jloss(x_, w_):
        y = jax_apply(x_, w_, use_pallas=True, block_k=block_k, interpret=True)
        return jnp.sum(jnp.abs(y) ** 2)

    gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xf), jnp.asarray(w))
    xt, wt = torch.from_numpy(xf).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = spectral_apply(xt, wt)
    (y.real ** 2 + y.imag ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.conj(np.asarray(gx)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.conj(np.asarray(gw)), rtol=RTOL, atol=ATOL)


def test_backward_takes_a_cotangent_of_any_layout():
    """A cotangent whose mode run is not contiguous (here an expanded one)
    is laid out for the kernels, and the gradients match plain autograd."""
    rng = np.random.default_rng(6)
    xf, w = _cplx(rng, (2, 3, 4, 5)), _cplx(rng, (3, 4, 4, 5))
    g = torch.from_numpy(_cplx(rng, (1, 4, 1, 5))).expand(2, 4, 4, 5)
    got, want = [], []
    for op, out in ((spectral_apply, got), (spectral_apply_ref, want)):
        leaves = [torch.from_numpy(z).requires_grad_() for z in (xf, w)]
        op(*leaves).backward(g)
        out += [t.grad for t in leaves]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_dx_is_the_mix_on_conj_transposed_weights():
    rng = np.random.default_rng(5)
    g, w = _cplx(rng, (2, 4, 3, 5)), _cplx(rng, (3, 4, 3, 5))
    want = np.asarray(jax_apply_ref(jnp.asarray(g), jnp.asarray(np.conj(w).transpose(1, 0, 2, 3))))
    got = spectral_apply_dx(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _z(shape, dtype=torch.complex64):
    return torch.zeros(shape, dtype=dtype)


# (call, message): each violates one check of the wrappers
BAD = [
    ("wrong dtype", lambda: spectral_apply(_z((1, 2, 3), torch.complex128), _z((2, 2, 3), torch.complex128)),
     "complex64"),
    ("real dtype", lambda: spectral_apply(_z((1, 2, 3), torch.float32), _z((2, 2, 3), torch.float32)),
     "complex64"),
    ("mismatched ci", lambda: spectral_apply(_z((1, 3, 4, 2)), _z((2, 2, 4, 2))), "channels"),
    ("mismatched modes", lambda: spectral_apply(_z((1, 2, 4, 2)), _z((2, 2, 4, 3))), "modes"),
    ("no mode dim", lambda: spectral_apply(_z((1, 2)), _z((2, 2))), "rank"),
    ("non-contiguous mode run", lambda: spectral_apply(_z((1, 2, 3, 4)).transpose(2, 3), _z((2, 2, 4, 3))),
     "contiguous run"),
    ("dx mismatched co", lambda: spectral_apply_dx(_z((1, 3, 4)), _z((2, 2, 4))), "channels"),
    ("dw mismatched batch", lambda: spectral_apply_dw(_z((1, 2, 4)), _z((2, 3, 4))), "batch"),
    ("dw non-contiguous mode run", lambda: spectral_apply_dw(_z((1, 2, 4, 6))[..., ::2], _z((1, 3, 4, 3))),
     "contiguous run"),
]


@pytest.mark.parametrize("name,call,match", BAD, ids=[c[0] for c in BAD])
def test_validation_errors(name, call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.fixture
def fake_stream(monkeypatch):
    """Let the CUDA wrappers run their host side on CPU tensors: no device
    context and a null stream (the launches themselves are faked)."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


def test_no_silent_fallback(monkeypatch, fake_stream):
    """Only CPU tensors take the plain version: other devices and mixed
    devices raise; a kernel library that fails to build or a launch that
    fails raises, and neither counts as a launch."""
    x, w = _z((1, 2, 3)), _z((2, 2, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        spectral_apply(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        spectral_apply(x, w.to("meta"))

    def no_library():
        raise RuntimeError("cannot build the CUDA kernels")

    monkeypatch.setattr(ops, "load_library", no_library)
    before = (spectral_apply_cuda.launches, spectral_dw_cuda.launches)
    with pytest.raises(RuntimeError, match="cannot build"):
        spectral_apply_cuda(x, w)
    with pytest.raises(RuntimeError, match="cannot build"):
        spectral_dw_cuda(x, x)

    failing = types.SimpleNamespace(
        spectral_apply_launch=lambda *args: 700,
        spectral_dw_launch=lambda *args: 700,
        spectral_fused_error_string=lambda err: b"an illegal memory access was encountered",
    )
    monkeypatch.setattr(ops, "load_library", lambda: failing)
    with pytest.raises(RuntimeError, match="spectral_apply kernel launch failed: an illegal"):
        spectral_apply_cuda(x, w)
    with pytest.raises(RuntimeError, match="spectral_dw kernel launch failed"):
        spectral_dw_cuda(x, x)
    assert (spectral_apply_cuda.launches, spectral_dw_cuda.launches) == before


def test_wrappers_pass_strides_and_sizes(monkeypatch, fake_stream):
    """What the wrappers hand the C interface: batch, channel and K sizes,
    the batch and channel strides (swapped weight strides and the conjugate
    flag for dx) and the output pointer; one launch counted per call."""
    calls = []
    lib = types.SimpleNamespace(
        spectral_apply_launch=lambda *a: calls.append(("apply",) + a[3:12]) or 0,
        spectral_dw_launch=lambda *a: calls.append(("dw",) + a[3:11]) or 0,
    )
    monkeypatch.setattr(ops, "load_library", lambda: lib)
    x = _channels_outermost(_z((2, 3, 4, 5)))     # strides (20, 40, 5, 1)
    w = _z((3, 6, 4, 5))                           # strides (120, 20, 5, 1)
    g = _z((2, 6, 4, 5))
    before = (spectral_apply_cuda.launches, spectral_dw_cuda.launches)
    assert spectral_apply_cuda(x, w).shape == (2, 6, 4, 5)
    assert spectral_apply_cuda(g, w, conj_transpose=True).shape == (2, 3, 4, 5)
    assert spectral_dw_cuda(x, g).shape == (3, 6, 4, 5)
    assert calls == [
        ("apply", 2, 3, 6, 20, 20, 40, 120, 20, 0),
        ("apply", 2, 6, 3, 20, 120, 20, 20, 120, 1),
        ("dw", 2, 3, 6, 20, 20, 40, 120, 20),
    ]
    assert (spectral_apply_cuda.launches, spectral_dw_cuda.launches) == (before[0] + 2, before[1] + 1)
