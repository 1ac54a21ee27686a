"""The port's serial FNO vs the JAX reference, on the CPU.

Parameters come from the reference's ``init_params`` and cross over through
numpy (``params_from_numpy``); inputs are made with numpy from a seed. The
JAX side runs with ``use_pallas=True`` (the fused Pallas kernel in
interpret mode). Gate: rtol=1e-4, atol=1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import fno as jfno
from repro_torch.core import fno as tfno

RTOL, ATOL = 1e-4, 1e-5
GRID, MODES = (8, 8, 4, 6), (2, 2, 1, 2)


def _cfgs(in_channels=1):
    jcfg = jfno.FNOConfig(
        grid=GRID, modes=MODES, width=4, in_channels=in_channels, n_blocks=2,
        decoder_dim=8, use_pallas=True,
    )
    tcfg = tfno.FNOConfig(
        grid=GRID, modes=MODES, width=4, in_channels=in_channels, n_blocks=2,
        decoder_dim=8,
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs(in_channels=2)
    params = jax.device_get(jfno.init_params(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, params, tfno.params_from_numpy(params, "cpu")


def _x(seed, c):
    return np.random.default_rng(seed).standard_normal((2, c) + GRID).astype(np.float32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fno_forward_matches_jax(model):
    jcfg, tcfg, params, tparams = model
    x = _x(0, 2)
    want = jax.jit(lambda p, x: jfno.fno_forward(p, x, jcfg))(params, x)
    with torch.inference_mode():
        _close(tfno.fno_forward(tparams, torch.from_numpy(x), tcfg), want)
        # the unfused oracle agrees with the fused path too
        _close(tfno.fno_forward_unfused(tparams, torch.from_numpy(x), tcfg), want)


def test_split_forwards_match_jax(model):
    """fno_forward_split, spectral_prelift and fno_forward_deep_split on the
    same cached operands as the reference."""
    jcfg, tcfg, params, tparams = model
    x = _x(1, 2)
    pre = np.array(jfno.encoder_prelift(params, x[:, :1], jcfg, slice(0, 1)))
    with torch.inference_mode():
        tpre = tfno.encoder_prelift(tparams, torch.from_numpy(x[:, :1]), tcfg, slice(0, 1))
        _close(tpre, pre)

        want = jax.jit(lambda p, s, d: jfno.fno_forward_split(p, s, d, jcfg, 1))(
            params, pre, x[:, 1:]
        )
        _close(tfno.fno_forward_split(
            tparams, torch.from_numpy(pre), torch.from_numpy(x[:, 1:]), tcfg, 1
        ), want)

        spectra, contrib = jfno.spectral_prelift(params, pre, jcfg)
        tspectra, tcontrib = tfno.spectral_prelift(tparams, torch.from_numpy(pre), tcfg)
        _close(tspectra, spectra)
        _close(tcontrib, contrib)
        # unbatched prelift
        _close(tfno.spectral_prelift(tparams, torch.from_numpy(pre[0]), tcfg)[1], contrib[0])

        contrib = np.array(contrib)
        want = jax.jit(
            lambda p, c, s, d: jfno.fno_forward_deep_split(p, c, s, d, jcfg, 1)
        )(params, contrib, pre, x[:, 1:])
        _close(tfno.fno_forward_deep_split(
            tparams, torch.from_numpy(contrib), torch.from_numpy(pre),
            torch.from_numpy(x[:, 1:]), tcfg, 1,
        ), want)


def test_params_numpy_round_trip(model):
    jcfg, tcfg, params, tparams = model
    back = tfno.params_to_numpy(tparams)
    shapes = tfno.param_shapes(tcfg)
    for group in params:
        for name, leaf in params[group].items():
            np.testing.assert_array_equal(back[group][name], leaf)
            assert back[group][name].dtype == leaf.dtype
            assert tuple(shapes[group][name]) == leaf.shape
    assert tparams["blocks"]["w_spec"].dtype == torch.complex64


def test_init_params_layout_and_seed():
    """The port's init has the reference's leaves, shapes, dtypes and
    scales, and a generator seed fixes it."""
    jcfg, tcfg = _cfgs()
    ref = jax.device_get(jfno.init_params(jax.random.PRNGKey(0), jcfg))
    a = tfno.init_params(tcfg, generator=torch.Generator().manual_seed(5), device="cpu")
    b = tfno.init_params(tcfg, generator=torch.Generator().manual_seed(5), device="cpu")
    for group in ref:
        for name, leaf in ref[group].items():
            t = a[group][name]
            assert tuple(t.shape) == leaf.shape
            assert t.numpy().dtype == leaf.dtype
            assert torch.equal(t, b[group][name])
            bound = float(np.abs(leaf).max()) if leaf.size else 0.0
            if bound == 0.0:
                assert not t.abs().any()
    spec_bound = 1.0 / tcfg.width ** 2
    assert float(torch.view_as_real(a["blocks"]["w_spec"]).abs().max()) <= spec_bound


def test_gelu_is_the_tanh_form():
    """Every GELU in the port is jax.nn.gelu's default tanh form; the exact
    erf form would miss the 1e-4 gate."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    port = tfno._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - port).max() > 1e-4


def test_config_matches_reference():
    from repro.configs.fno_sleipner import CONFIG as JCONFIG
    from repro_torch.configs.fno_sleipner import CONFIG as TCONFIG

    names = [f.name for f in dataclasses.fields(TCONFIG) if f.name != "dtype"]
    for name in names:
        assert getattr(TCONFIG, name) == getattr(JCONFIG, name), name
    assert TCONFIG.mode_shape == JCONFIG.mode_shape


def test_conv_and_decoder_take_permuted_layouts():
    """The 1x1 convs and the decoder take the permuted layout cuFFT returns
    and equal the contiguous computation."""
    _, tcfg = _cfgs()
    params = tfno.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    nx, ny, nz, nt = GRID
    x = torch.randn((2, tcfg.width, nt, nx, ny, nz), generator=g).permute(0, 1, 3, 4, 5, 2)
    assert not x.is_contiguous()
    w, b = params["blocks"]["w_bypass"][0], torch.randn(tcfg.width, generator=g)
    y = tfno._conv1x1(x, w, b)
    want = torch.einsum("bixyzt,io->boxyzt", x, w) + b.view(1, -1, 1, 1, 1, 1)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        tfno._decoder(params, x, tcfg), tfno._decoder(params, x.contiguous(), tcfg),
        rtol=1e-5, atol=1e-6,
    )
