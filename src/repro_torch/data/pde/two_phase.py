"""Two-phase (CO2/brine) porous-media flow — the OPM stand-in (paper §V-B).

Port of ``repro.data.pde.two_phase``: the scenario builders (geomodel,
injection wells) in numpy, byte-identical to the reference's, and the
IMPES simulator in plain PyTorch on any device. IMPES on a regular 3-D
grid: implicit incompressible pressure (variable-coefficient 7-point
stencil solved with matrix-free CG), explicit upwind saturation transport
with Corey relative permeabilities, buoyancy (CO2 rises), and
rate-controlled injection wells. The geomodel generator makes
Sleipner-like layered permeability (high-perm sands separated by thin
shale barriers) so plumes pond under barriers and migrate up-dip.

Inputs/outputs mirror the paper: input = binary map of injector cells
(repeated along t by the data pipeline); output = CO2 saturation history
[nx, ny, nz, nt].

The simulator keeps the reference's order of operations, so on the CPU it
agrees with the JAX one to float32 rounding (tests/test_torch_data.py).
The CG stops where ``jax.scipy.sparse.linalg.cg`` stops (x0 = 0; while
``r.r > max(tol^2 b.b, atol^2)`` and ``k < maxiter``), without a host
sync per iteration: a converged solve freezes its iterate on the device
(``torch.where``), which equals stopping, and the host reads the flag once
every ``CG_CHECK_EVERY`` iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device

# Iterations between the host's reads of the CG's convergence flag.
CG_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class TwoPhaseConfig:
    grid: Tuple[int, int, int] = (32, 16, 8)   # (nx, ny, nz), z down
    nt_frames: int = 8
    dt_frame: float = 30.0       # days per output frame
    substeps: int = 10
    mu_w: float = 1.0            # brine viscosity (cP)
    mu_n: float = 0.07           # CO2 viscosity
    swc: float = 0.1             # connate water
    snr: float = 0.05            # residual CO2
    # Buoyancy face-velocity scale. CFL bound: |v| dt_sub / phi < 1 with
    # dt_sub = dt_frame/substeps = 3 days, phi ~ 0.2 -> |v| << 0.067.
    # The face velocity is gravity * min(lam_z, gravity_lam_cap), so the cap
    # keeps buoyant velocity CFL-stable as CO2 mobility (1/mu_n ~ 14) and
    # permeability grow along the plume.
    gravity: float = 0.02
    gravity_lam_cap: float = 1.0
    inj_rate: float = 0.02       # total injected volume per day (scaled)
    cg_tol: float = 1e-6
    cg_iters: int = 200
    seed: int = 0


def make_geomodel(cfg: TwoPhaseConfig, seed: int = 0):
    """Layered lognormal permeability + thin low-perm barriers; porosity.
    Returns float32 numpy arrays (k, phi) of shape ``cfg.grid``."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = cfg.grid
    base = rng.lognormal(mean=0.0, sigma=0.4, size=(nx, ny, nz))
    layers = np.exp(0.8 * np.sin(np.linspace(0, 3 * np.pi, nz)))[None, None, :]
    k = base * layers
    for zb in range(2, nz, 3):  # shale streaks every ~3 cells
        k[:, :, zb] *= 0.05
    phi = 0.2 + 0.05 * (k / k.max())
    return k.astype(np.float32), phi.astype(np.float32)


def random_well_mask(cfg: TwoPhaseConfig, n_wells: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nx, ny, nz = cfg.grid
    mask = np.zeros(cfg.grid, np.float32)
    for _ in range(n_wells):
        i = rng.integers(2, nx - 2)
        j = rng.integers(2, ny - 2)
        mask[i, j, nz - 3 :] = 1.0  # perforate near the bottom
    return mask


def geomodel_channel(grid, nt: int, seed: int = 0) -> np.ndarray:
    """The shared log-permeability geomodel as a [1, nx, ny, nz, nt] input
    channel, repeated along t — the construction the reference's datagen
    uses, so an ensemble's geomodel is byte-identical across scenarios."""
    k, _ = make_geomodel(TwoPhaseConfig(grid=tuple(grid)), seed=seed)
    logk = np.log(k)
    return np.repeat(logk[None, :, :, :, None], nt, axis=-1).astype(np.float32)


def _harmonic_face_perm(k):
    """Harmonic mean transmissibilities on interior faces."""
    hx = 2 * k[1:] * k[:-1] / (k[1:] + k[:-1] + 1e-30)
    hy = 2 * k[:, 1:] * k[:, :-1] / (k[:, 1:] + k[:, :-1] + 1e-30)
    hz = 2 * k[:, :, 1:] * k[:, :, :-1] / (k[:, :, 1:] + k[:, :, :-1] + 1e-30)
    return hx, hy, hz


def _rel_perms(s, cfg):
    """Corey curves. s = CO2 (non-wetting) saturation."""
    se = torch.clamp((s - cfg.snr) / (1 - cfg.swc - cfg.snr), 0.0, 1.0)
    krn = se ** 2
    krw = (1 - se) ** 2
    return krw, krn


def _mobility(s, cfg):
    krw, krn = _rel_perms(s, cfg)
    return krw / cfg.mu_w + krn / cfg.mu_n


def _scatter_faces(out, f, dim):
    """The reference's ``out.at[:-1].add(f).at[1:].add(-f)`` along ``dim``:
    +f on the face's low cell, -f on its high cell (``sub_`` is the add of
    -f, bit for bit)."""
    n = out.shape[dim]
    out.narrow(dim, 0, n - 1).add_(f)
    out.narrow(dim, 1, n - 1).sub_(f)


def _diff(p, dim):
    n = p.shape[dim]
    return p.narrow(dim, 1, n - 1) - p.narrow(dim, 0, n - 1)


def _pressure_matvec(p, lam_face, cfg):
    """A p = -div(lam K grad p) with no-flow boundaries."""
    out = torch.zeros_like(p)
    for dim, lam in enumerate(lam_face):
        _scatter_faces(out, lam * _diff(p, dim), dim)
    return -out + 1e-6 * p  # tiny regularization pins the nullspace


def _vdot(a, b):
    return torch.sum(a * b)


def _cg(matvec, b, *, tol, maxiter, atol=0.0):
    """(x, k): CG on ``matvec`` x = b from x0 = 0, stopping as
    ``jax.scipy.sparse.linalg.cg`` stops, with ``k`` (a 0-d int tensor on
    b's device) the iterations it took. Converged iterates are frozen on
    the device; the host reads the flag every ``CG_CHECK_EVERY`` steps."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = _vdot(r, r)
    # jnp.square of the weak-typed float: squared in float32, as there
    tol2, atol2 = (torch.tensor(t, dtype=b.dtype, device=b.device).square() for t in (tol, atol))
    atol2 = torch.maximum(tol2 * _vdot(b, b), atol2)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    active = gamma > atol2
    for it in range(maxiter):
        if it % CG_CHECK_EVERY == 0 and not bool(active):
            break
        ap = matvec(p)
        alpha = gamma / _vdot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = _vdot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        k.add_(active)
        # a frozen gamma stays <= atol2, so this is ``active & (gamma >
        # atol2)``; the loop's own bound is the reference's k < maxiter
        active = gamma > atol2
    return x, k


def _solve_pressure(s, k_faces, q, cfg):
    """(p, lam_face, cg iterations)."""
    lamc = _mobility(s, cfg)
    lam_face = tuple(
        kf * 0.5 * (lamc.narrow(d, 1, lamc.shape[d] - 1) + lamc.narrow(d, 0, lamc.shape[d] - 1))
        for d, kf in enumerate(k_faces)
    )
    p, k = _cg(lambda v: _pressure_matvec(v, lam_face, cfg), q, tol=cfg.cg_tol,
               maxiter=cfg.cg_iters)
    return p, lam_face, k


def _frac_flow(sv, cfg):
    krw, krn = _rel_perms(sv, cfg)
    mw, mn = krw / cfg.mu_w, krn / cfg.mu_n
    return mn / (mw + mn + 1e-12)


def _face_flux(pm, sp, sm, lam, cfg, grav=None):
    v = -lam * pm  # total velocity at face (+ gravity term)
    if grav is not None:
        v = v + grav
    f_up = torch.where(v > 0, _frac_flow(sm, cfg), _frac_flow(sp, cfg))
    return f_up * v


def _upwind_flux(p, s, lam_face, cfg):
    """CO2 mass flux with phase upwinding + gravity segregation (z up-flux).
    div(c) accumulates +F for the face (c, c+1) (flux positive toward c+1
    leaves cell c) and -F at c+1."""
    out = torch.zeros_like(s)
    for dim, lam in enumerate(lam_face):
        n = s.shape[dim]
        # z: gravity drives CO2 upward (toward smaller z index = shallower)
        grav = -cfg.gravity * torch.clamp(lam, max=cfg.gravity_lam_cap) if dim == 2 else None
        f = _face_flux(_diff(p, dim), s.narrow(dim, 1, n - 1), s.narrow(dim, 0, n - 1), lam,
                       cfg, grav)
        _scatter_faces(out, f, dim)
    return out


def simulate(well_mask, cfg: TwoPhaseConfig = TwoPhaseConfig(), seed: int = 0, *,
             device=None, cg_iters: Optional[list] = None) -> torch.Tensor:
    """well_mask: [nx,ny,nz] binary injector cells -> saturation [*, nt], a
    float32 tensor on ``device`` (default: the card). ``cg_iters``, when
    given, receives the CG iteration count of every pressure solve."""
    device = resolve_device(device)
    mask = torch.as_tensor(np.asarray(well_mask, np.float32)).to(device)
    k_np, phi_np = make_geomodel(cfg, seed)
    k_faces = _harmonic_face_perm(torch.from_numpy(k_np).to(device))
    phi = torch.from_numpy(phi_np).to(device)
    n_wells = torch.clamp(torch.sum(mask), min=1.0)
    q = mask * cfg.inj_rate / n_wells  # injection source
    q = q - torch.mean(q)              # closed box: balance sources
    dt = cfg.dt_frame / cfg.substeps
    rate = torch.full((), cfg.inj_rate, device=device) / n_wells
    src = torch.where(mask > 0, rate, 0.0)

    s = torch.zeros(cfg.grid, dtype=torch.float32, device=device)
    frames, counts = [], []
    for _ in range(cfg.nt_frames):
        for _ in range(cfg.substeps):
            p, lam_face, k = _solve_pressure(s, k_faces, q, cfg)
            counts.append(k)
            div = _upwind_flux(p, s, lam_face, cfg)
            s_new = s + dt * (src - div) / phi
            s = torch.clamp(s_new, 0.0, 1.0 - cfg.swc)
        frames.append(s)
    if cg_iters is not None:
        cg_iters.extend(int(v) for v in torch.stack(counts).cpu())
    return torch.stack(frames, dim=-1)  # [nx,ny,nz,nt]


def simulate_task(seed: int, n_wells: int = 2, grid=(32, 16, 8), nt: int = 8, device=None):
    """Top-level picklable entry for the cloud batch API: (mask, saturation)
    as numpy arrays, simulated on ``device`` (default: the card)."""
    cfg = TwoPhaseConfig(grid=tuple(grid), nt_frames=nt)
    mask = random_well_mask(cfg, n_wells, seed)
    with torch.no_grad():
        sat = simulate(mask, cfg, seed=0, device=device)
    return mask, sat.cpu().numpy()
