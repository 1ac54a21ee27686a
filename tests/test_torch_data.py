"""The port's PDE simulators vs the JAX package's, on the CPU.

Two-phase (IMPES + CG): the saturation history within atol 1e-4 of the
JAX simulator's at (16,8,8) x 6 frames and at the default (32,16,8) x 8
(saturation lies in [0, 0.9]); the geomodel, porosity and well masks bit
for bit. Navier-Stokes: the sphere mask bit for bit and the vorticity
within 1e-5 of its max|ref| at n = 16 x 4 frames. Then the reference's
physics checks (``tests/test_data.py``) on the port's outputs, the CG's
iteration counts, and that freezing a converged CG on the device equals
stopping it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pde import navier_stokes as jns
from repro.data.pde import two_phase as jtp
from repro_torch.data.pde import navier_stokes as tns
from repro_torch.data.pde import two_phase as ttp

SAT_ATOL = 1e-4
VORT_RTOL_OF_MAX = 1e-5
TWO_PHASE_CASES = {"16x8x8_nt6": ((16, 8, 8), 6), "32x16x8_nt8": ((32, 16, 8), 8)}


@pytest.fixture(scope="module")
def two_phase_runs():
    """(port mask, port saturation, CG counts, JAX mask, JAX saturation)
    of ``simulate_task(1, 2, grid, nt)`` per case."""
    out = {}
    for name, (grid, nt) in TWO_PHASE_CASES.items():
        cfg = ttp.TwoPhaseConfig(grid=grid, nt_frames=nt)
        mask = ttp.random_well_mask(cfg, 2, 1)
        iters = []
        with torch.no_grad():
            sat = ttp.simulate(mask, cfg, seed=0, device="cpu", cg_iters=iters).numpy()
        jmask, jsat = jtp.simulate_task(1, 2, grid, nt)
        out[name] = (mask, sat, iters, jmask, np.asarray(jsat))
    return out


@pytest.mark.parametrize("case", TWO_PHASE_CASES)
def test_two_phase_saturation_matches_jax(two_phase_runs, case):
    mask, sat, _, jmask, jsat = two_phase_runs[case]
    np.testing.assert_array_equal(mask, jmask)
    assert sat.shape == jsat.shape == TWO_PHASE_CASES[case][0] + (TWO_PHASE_CASES[case][1],)
    np.testing.assert_allclose(sat, jsat, rtol=0, atol=SAT_ATOL)


def test_simulate_task_is_simulate(two_phase_runs):
    mask, sat = ttp.simulate_task(1, 2, (16, 8, 8), 6, device="cpu")
    np.testing.assert_array_equal(mask, two_phase_runs["16x8x8_nt6"][0])
    np.testing.assert_array_equal(sat, two_phase_runs["16x8x8_nt6"][1])


@pytest.mark.parametrize("grid,seed", [((16, 8, 8), 0), ((32, 16, 8), 3), ((12, 6, 10), 7)])
def test_scenario_builders_are_bitwise_the_reference(grid, seed):
    k, phi = ttp.make_geomodel(ttp.TwoPhaseConfig(grid=grid), seed)
    jk, jphi = jtp.make_geomodel(jtp.TwoPhaseConfig(grid=grid), seed)
    np.testing.assert_array_equal(k, np.asarray(jk))
    np.testing.assert_array_equal(phi, np.asarray(jphi))
    np.testing.assert_array_equal(
        ttp.random_well_mask(ttp.TwoPhaseConfig(grid=grid), 3, seed),
        jtp.random_well_mask(jtp.TwoPhaseConfig(grid=grid), 3, seed))


def test_cg_iterations_are_counted(two_phase_runs):
    for case, (grid, nt) in TWO_PHASE_CASES.items():
        iters = two_phase_runs[case][2]
        assert len(iters) == nt * ttp.TwoPhaseConfig().substeps
        assert all(1 <= k <= ttp.TwoPhaseConfig().cg_iters for k in iters), iters
    # the small grid converges before the cap, the default one reaches it
    assert max(two_phase_runs["16x8x8_nt6"][2]) < 200
    assert min(two_phase_runs["32x16x8_nt8"][2]) == 200


def test_frozen_cg_equals_stopped_cg(monkeypatch):
    """A converged solve keeps its iterate on the device until the host
    reads the flag: the result is bit for bit that of reading it every
    iteration (stopping exactly there)."""
    cfg = ttp.TwoPhaseConfig(grid=(16, 8, 8), nt_frames=2)
    mask = ttp.random_well_mask(cfg, 2, 1)
    runs = []
    for every in (1, 7, 1000):
        monkeypatch.setattr(ttp, "CG_CHECK_EVERY", every)
        iters = []
        with torch.no_grad():
            runs.append((ttp.simulate(mask, cfg, device="cpu", cg_iters=iters), iters))
    for sat, iters in runs[1:]:
        assert iters == runs[0][1]
        assert torch.equal(sat, runs[0][0])
    assert max(runs[0][1]) < cfg.cg_iters  # the solves did stop early


def test_co2_simulation_physics(two_phase_runs):
    """tests/test_data.py::test_co2_simulation_physics on the port."""
    mask, sat, *_ = two_phase_runs["16x8x8_nt6"]
    assert sat.shape == (16, 8, 8, 6)
    assert np.isfinite(sat).all()
    assert (sat >= 0).all() and (sat <= 0.95).all()
    totals = [sat[..., t].sum() for t in range(6)]
    assert all(b >= a - 1e-3 for a, b in zip(totals, totals[1:]))
    assert totals[-1] > totals[0]
    assert (sat[..., -1] > 0.05).sum() > mask.sum()


def test_co2_buoyancy():
    """tests/test_data.py::test_co2_buoyancy on the port."""
    cfg = ttp.TwoPhaseConfig(grid=(12, 6, 10), nt_frames=8)
    mask = np.zeros(cfg.grid, np.float32)
    mask[6, 3, 7] = 1.0  # single deep injector
    with torch.no_grad():
        sat = ttp.simulate(mask, cfg, device="cpu").numpy()
    z = np.arange(10)[None, None, :]
    z_first = (sat[..., 1] * z).sum() / max(sat[..., 1].sum(), 1e-9)
    z_last = (sat[..., -1] * z).sum() / max(sat[..., -1].sum(), 1e-9)
    assert z_last < z_first + 1e-6


@pytest.fixture(scope="module")
def ns_run():
    cfg = jns.NSConfig(n=16, nt_frames=4)
    center = (0.4, 0.5, 0.55)
    chi, vort = jax.jit(lambda c: jns.simulate(c, cfg))(jnp.asarray(center, jnp.float32))
    tchi, tvort = tns.simulate_task(center, 16, 4, device="cpu")
    return np.asarray(chi), np.asarray(vort), tchi, tvort


def test_navier_stokes_matches_jax(ns_run):
    chi, vort, tchi, tvort = ns_run
    np.testing.assert_array_equal(tchi, chi)
    assert tvort.shape == vort.shape == (16, 16, 16, 4)
    np.testing.assert_allclose(tvort, vort, rtol=0,
                               atol=VORT_RTOL_OF_MAX * float(np.abs(vort).max()))


def test_ns_simulation_physics():
    """tests/test_data.py::test_ns_simulation_physics on the port."""
    cfg = tns.NSConfig(n=16, nt_frames=4, steps_per_frame=5)
    center = torch.tensor([0.4, 0.5, 0.5])
    with torch.no_grad():
        chi, vort = tns.simulate(center, cfg, device="cpu")
    assert chi.shape == (16, 16, 16) and vort.shape == (16, 16, 16, 4)
    assert bool(torch.isfinite(vort).all())
    assert float(vort[..., -1].max()) > 0.1
    mask = tns.sphere_mask(cfg, center).numpy()
    assert mask.sum() > 0
    com = np.array(np.nonzero(mask)).mean(axis=1) / 16
    np.testing.assert_allclose(com, center.numpy(), atol=0.1)


def test_ns_divergence_free():
    """tests/test_data.py::test_ns_divergence_free on the port."""
    cfg = tns.NSConfig(n=16, nt_frames=1, steps_per_frame=5)
    kx, ky, kz, k2 = tns._wavenumbers(cfg.n)
    chi = tns.sphere_mask(cfg, torch.tensor([0.5, 0.5, 0.5]))
    u0 = torch.zeros((3, 16, 16, 16))
    u0[0] = 1.0
    uh = tns._project(torch.fft.fftn(u0, dim=(1, 2, 3)), kx, ky, kz, k2)
    for _ in range(3):
        r = tns._rhs(uh, chi, cfg, kx, ky, kz, k2)
        uh = tns._project(uh + cfg.dt * r, kx, ky, kz, k2)
    div = kx * uh[0] + ky * uh[1] + kz * uh[2]
    assert float(div.abs().max()) < 1e-3 * float(uh.abs().max())


@pytest.mark.parametrize("simulate_task,args", [
    (ttp.simulate_task, (0, 1, (8, 8, 4), 1)),
    (tns.simulate_task, ((0.5, 0.5, 0.5), 8, 1)),
], ids=["two_phase", "navier_stokes"])
def test_simulators_need_a_card_or_device_cpu(monkeypatch, simulate_task, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_task(*args)
