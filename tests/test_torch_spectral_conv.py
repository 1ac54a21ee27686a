"""The port's fused spectral op vs the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs the Pallas kernels ``spectral_fused_pallas`` and
``spectral_fused_dw`` in interpret mode and its unfused oracle
``spectral_apply_fused_ref``; the port's CPU path is its plain version.
Gradients are compared in torch's convention: JAX's cotangent of a complex
input is the conjugate of torch's ``.grad``. Gate: rtol=1e-4, atol=1e-5
(float32 sums in another order). The CUDA kernels themselves run only on
the card (``tests/test_torch_cuda_kernels.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spectral_conv import (
    spectral_apply_fused as jax_fused,
    spectral_apply_fused_add as jax_fused_add,
    spectral_apply_fused_ref as jax_fused_ref,
    spectral_static_contribution as jax_static_contribution,
)
from repro.kernels.spectral_conv.kernel import spectral_fused_dw as jax_fused_dw
from repro.kernels.spectral_conv.kernel import spectral_fused_pallas
from repro_torch.kernels.spectral_conv import (
    pad_kept_ref,
    spectral_apply_fused,
    spectral_apply_fused_add,
    spectral_fused_dw,
    spectral_static_contribution,
)

RTOL, ATOL = 1e-4, 1e-5


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _problem(seed, b, ci, co, dims, t_in, kt, with_add):
    """dims: 3 pairs (N, K) for a full-spectrum dim or (None, K) for a
    pre-truncated one."""
    rng = np.random.default_rng(seed)
    trunc = tuple(n for n, _ in dims)
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    xf = _cplx(rng, (b, ci) + ext + (t_in,))
    w = _cplx(rng, (ci, co) + kept)
    add = _cplx(rng, (b, co) + kept) if with_add else None
    return xf, w, add, trunc


# (trunc pattern, dims, t_in, kt, t_out, add)
CASES = [
    ("NNN-tail", [(6, 4), (4, 2), (4, 4)], 5, 3, 5, False),
    ("NNN-add", [(6, 2), (5, 4), (3, 2)], 3, 3, None, True),
    ("N--tail-add", [(8, 4), (None, 3), (None, 2)], 4, 2, 6, True),
    ("N--", [(7, 6), (None, 2), (None, 3)], 3, 3, None, False),
    ("N-N-tail", [(6, 4), (None, 3), (4, 2)], 4, 3, 4, False),
    ("N-N-add", [(5, 2), (None, 2), (6, 4)], 2, 2, None, True),
]


@pytest.mark.parametrize("name,dims,t_in,kt,t_out,with_add", CASES, ids=[c[0] for c in CASES])
def test_fused_matches_jax(name, dims, t_in, kt, t_out, with_add):
    xf, w, add, trunc = _problem(len(name), 2, 3, 4, dims, t_in, kt, with_add)
    xt, wt = torch.from_numpy(xf), torch.from_numpy(w)
    if with_add:
        got = spectral_apply_fused_add(xt, wt, torch.from_numpy(add), trunc, t_out=t_out)
        pallas = jax_fused_add(
            jnp.asarray(xf), jnp.asarray(w), jnp.asarray(add), trunc, t_out=t_out,
            use_pallas=True, interpret=True,
        )
        oracle = jax_fused_add(
            jnp.asarray(xf), jnp.asarray(w), jnp.asarray(add), trunc, t_out=t_out,
            use_pallas=False,
        )
    else:
        got = spectral_apply_fused(xt, wt, trunc, t_out=t_out)
        yr, yi = spectral_fused_pallas(
            jnp.asarray(xf.real), jnp.asarray(xf.imag),
            jnp.asarray(w.real), jnp.asarray(w.imag),
            trunc=trunc, t_out=t_out, interpret=True,
        )
        pallas = np.asarray(yr) + 1j * np.asarray(yi)
        oracle = jax_fused_ref(jnp.asarray(xf), jnp.asarray(w), trunc, t_out)
    got = got.numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)


def test_pad_kept_and_static_contribution_match_jax():
    rng = np.random.default_rng(3)
    yk = _cplx(rng, (2, 3, 4, 2, 3, 2))
    trunc, t_out = (7, 5, None), 4
    from repro.kernels.spectral_conv import pad_kept_ref as jax_pad_kept

    np.testing.assert_array_equal(
        pad_kept_ref(torch.from_numpy(yk), trunc, t_out).numpy(),
        np.asarray(jax_pad_kept(jnp.asarray(yk), trunc, t_out)),
    )
    sf = _cplx(rng, (3, 4, 2, 2, 3))
    w = _cplx(rng, (3, 5, 4, 2, 2, 3))
    for s in (sf, sf[None]):
        np.testing.assert_allclose(
            spectral_static_contribution(torch.from_numpy(s), torch.from_numpy(w)).numpy(),
            np.asarray(jax_static_contribution(jnp.asarray(s), jnp.asarray(w))),
            rtol=RTOL, atol=ATOL,
        )


# (x shape, w shape, trunc, t_out): each violates one of the reference's checks
BAD = [
    ((1, 3, 4, 4, 4, 3), (2, 2, 2, 2, 2, 3), (4, 4, 4), None),   # ci mismatch
    ((1, 2, 4, 4, 4, 2), (2, 2, 2, 2, 2, 3), (4, 4, 4), None),   # time bins < kt
    ((1, 2, 4, 4, 4, 3), (2, 2, 2, 2, 2, 3), (4, 4, 4), 2),      # t_out < kt
    ((1, 2, 4, 3, 4, 3), (2, 2, 2, 2, 2, 3), (4, None, 4), None),  # pre-truncated extent
    ((1, 2, 4, 4, 4, 3), (2, 2, 2, 2, 2, 3), (4, 5, 4), None),   # extent != full size
    ((1, 2, 4, 4, 4, 3), (2, 2, 3, 2, 2, 3), (4, 4, 4), None),   # odd kept extent
    ((1, 2, 4, 4, 4, 3), (2, 2, 6, 2, 2, 3), (4, 4, 4), None),   # kept > full
]


@pytest.mark.parametrize("x_shape,w_shape,trunc,t_out", BAD)
def test_validation_errors_match_jax(x_shape, w_shape, trunc, t_out):
    xf = np.zeros(x_shape, np.complex64)
    w = np.zeros(w_shape, np.complex64)
    with pytest.raises(ValueError) as jax_err:
        spectral_fused_pallas(
            jnp.asarray(xf.real), jnp.asarray(xf.imag),
            jnp.asarray(w.real), jnp.asarray(w.imag),
            trunc=trunc, t_out=t_out, interpret=True,
        )
    with pytest.raises(ValueError) as port_err:
        spectral_apply_fused(torch.from_numpy(xf), torch.from_numpy(w), trunc, t_out=t_out)
    assert str(port_err.value) == str(jax_err.value)


def test_no_silent_fallback():
    """Only CPU tensors take the plain version: other devices, mixed
    devices and other dtypes raise instead of being served some other way."""
    xf = torch.zeros((1, 2, 4, 4, 4, 3), dtype=torch.complex64)
    w = torch.zeros((2, 2, 2, 2, 2, 3), dtype=torch.complex64)
    with pytest.raises(ValueError, match="unsupported device"):
        spectral_apply_fused(xf.to("meta"), w.to("meta"), (4, 4, 4))
    with pytest.raises(ValueError, match="different devices"):
        spectral_apply_fused(xf, w.to("meta"), (4, 4, 4))
    with pytest.raises(ValueError, match="complex64"):
        spectral_apply_fused(xf.to(torch.complex128), w.to(torch.complex128), (4, 4, 4))
    with pytest.raises(ValueError, match="add shape"):
        spectral_apply_fused_add(xf, w, torch.zeros((1, 2, 2, 2, 2, 2), dtype=torch.complex64), (4, 4, 4))


# (name, dims, x time bins, g time bins, kt): the three trunc patterns, with
# and without t tails on either operand
DW_CASES = [
    ("NNN-tails", [(6, 4), (4, 2), (4, 4)], 5, 4, 3),
    ("NNN-no-tail", [(5, 2), (6, 4), (3, 2)], 2, 2, 2),
    ("N--", [(8, 4), (None, 3), (None, 2)], 4, 2, 2),
    ("N-N-tail", [(6, 4), (None, 3), (4, 2)], 3, 5, 3),
]


@pytest.mark.parametrize("name,dims,t_x,t_g,kt", DW_CASES, ids=[c[0] for c in DW_CASES])
def test_fused_dw_matches_jax_conjugated(name, dims, t_x, t_g, kt):
    """The port's weight cotangent (torch's convention) is the conjugate of
    JAX's Pallas ``spectral_fused_dw`` fed the conjugate cotangent."""
    rng = np.random.default_rng(len(name) + 50)
    trunc = tuple(n for n, _ in dims)
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    xf = _cplx(rng, (3, 2) + ext + (t_x,))
    g = _cplx(rng, (3, 4) + ext + (t_g,))
    got = spectral_fused_dw(torch.from_numpy(xf), torch.from_numpy(g), trunc, kept).numpy()
    gc = np.conj(g)
    wr, wi = jax_fused_dw(
        jnp.asarray(xf.real), jnp.asarray(xf.imag),
        jnp.asarray(gc.real), jnp.asarray(gc.imag),
        trunc=trunc, kept=kept, interpret=True,
    )
    assert got.shape == (2, 4) + kept and got.dtype == np.complex64
    np.testing.assert_allclose(
        got, np.conj(np.asarray(wr) + 1j * np.asarray(wi)), rtol=RTOL, atol=ATOL
    )


def test_fused_dw_time_bins_error_matches_jax():
    xf = np.zeros((1, 2, 4, 4, 4, 2), np.complex64)
    g = np.zeros((1, 2, 4, 4, 4, 3), np.complex64)
    kept, trunc = (2, 2, 2, 3), (4, 4, 4)
    with pytest.raises(ValueError) as jax_err:
        jax_fused_dw(
            jnp.asarray(xf.real), jnp.asarray(xf.imag),
            jnp.asarray(g.real), jnp.asarray(g.imag),
            trunc=trunc, kept=kept, interpret=True,
        )
    with pytest.raises(ValueError) as port_err:
        spectral_fused_dw(torch.from_numpy(xf), torch.from_numpy(g), trunc, kept)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="must match x"):
        spectral_fused_dw(torch.zeros((1, 2, 4, 4, 4, 3), dtype=torch.complex64),
                          torch.zeros((2, 2, 4, 4, 4, 3), dtype=torch.complex64),
                          trunc, kept)


def test_dw_variants_of_the_ab_tool_apply_to_the_source():
    """``launch/ab_dw.py`` builds its variants by textual substitution in
    ``spectral_fused_dw.cu``; each substitution must still find its text."""
    from repro_torch.launch.ab_dw import SOURCE, VARIANTS

    with open(SOURCE) as f:
        text = f.read()
    assert os.path.basename(SOURCE) == "spectral_fused_dw.cu"
    for name, subs in VARIANTS.items():
        for old, _ in subs:
            assert old in text, (name, old)


def test_mix_variants_of_the_ab_tool_apply_to_the_source():
    """``launch/ab_apply.py`` builds its variants by textual substitution in
    ``spectral_apply.cu``; each substitution must still find its text."""
    from repro_torch.launch.ab_apply import SOURCE, VARIANTS

    with open(SOURCE) as f:
        text = f.read()
    assert os.path.basename(SOURCE) == "spectral_apply.cu"
    for name, subs in VARIANTS.items():
        for old, _ in subs:
            assert old in text, (name, old)


@pytest.mark.parametrize("name,dims,t_in,kt,t_out,with_add", CASES, ids=[c[0] for c in CASES])
def test_fused_grads_match_jax_vjp(name, dims, t_in, kt, t_out, with_add):
    """dx, dW (and d add) of the port's autograd Function against
    ``jax.grad`` through the reference's custom_vjp on the Pallas kernels,
    compared through the same real loss sum(a*Re y + c*Im y)."""
    xf, w, add, trunc = _problem(len(name) + 7, 2, 3, 4, dims, t_in, kt, with_add)
    rng = np.random.default_rng(len(name))
    y_shape = np.asarray(jax_fused_ref(jnp.asarray(xf), jnp.asarray(w), trunc, t_out)).shape
    a = rng.standard_normal(y_shape).astype(np.float32)
    c = rng.standard_normal(y_shape).astype(np.float32)

    def jloss(x, w_, add_):
        if add_ is None:
            y = jax_fused(x, w_, trunc, t_out=t_out, use_pallas=True, interpret=True)
        else:
            y = jax_fused_add(x, w_, add_, trunc, t_out=t_out, use_pallas=True, interpret=True)
        return jnp.sum(jnp.real(y) * a + jnp.imag(y) * c)

    jargs = (jnp.asarray(xf), jnp.asarray(w), None if add is None else jnp.asarray(add))
    argnums = (0, 1, 2) if with_add else (0, 1)
    jgrads = jax.grad(jloss, argnums=argnums)(*jargs)

    targs = [torch.from_numpy(v).requires_grad_() for v in (xf, w, add) if v is not None]
    if with_add:
        y = spectral_apply_fused_add(targs[0], targs[1], targs[2], trunc, t_out=t_out)
    else:
        y = spectral_apply_fused(targs[0], targs[1], trunc, t_out=t_out)
    (y.real * torch.from_numpy(a) + y.imag * torch.from_numpy(c)).sum().backward()
    for t, jg in zip(targs, jgrads):
        np.testing.assert_allclose(
            t.grad.numpy(), np.conj(np.asarray(jg)), rtol=RTOL, atol=ATOL
        )
