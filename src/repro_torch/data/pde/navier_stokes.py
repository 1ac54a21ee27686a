"""3-D incompressible Navier-Stokes around an immersed sphere (WaterLily
stand-in, paper §V-A).

Port of ``repro.data.pde.navier_stokes`` in plain PyTorch on any device;
the FFTs go through ``torch.fft`` (cuFFT on the card), as the reference's
are XLA FFTs. Pseudo-spectral on a periodic box with Brinkman penalization
for the sphere: du/dt + (u.grad)u = -grad p + nu lap u - chi/eta (u - 0),
where chi is the sphere mask. A uniform background inflow U0 drives the
wake; the incompressibility projection is exact in Fourier space;
viscosity uses an integrating factor; time stepping is RK2. Output is the
vorticity magnitude on an nt-frame time grid — the paper's training
target (input = the binary sphere mask).

The reference's order of operations is kept, so on the CPU the mask
agrees bit for bit and the vorticity to FFT rounding
(tests/test_torch_data.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NSConfig:
    n: int = 32                 # grid points per dim
    nt_frames: int = 8          # output time frames
    steps_per_frame: int = 10
    dt: float = 0.01
    viscosity: float = 5e-3
    u0: float = 1.0             # background inflow (x direction)
    penalization: float = 1e-2  # Brinkman eta
    sphere_radius: float = 0.12 # in box units [0,1)


def sphere_mask(cfg: NSConfig, center: torch.Tensor) -> torch.Tensor:
    """Binary mask [n,n,n] of the immersed sphere (periodic distance) on
    ``center``'s device."""
    g = (torch.arange(cfg.n, dtype=torch.float32, device=center.device) + 0.5) / cfg.n
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")

    def pdist(a, c):
        d = torch.abs(a - c)
        return torch.minimum(d, 1.0 - d)

    r2 = pdist(x, center[0]) ** 2 + pdist(y, center[1]) ** 2 + pdist(z, center[2]) ** 2
    return (r2 < cfg.sphere_radius ** 2).to(torch.float32)


def _wavenumbers(n: int, device=None):
    k = torch.fft.fftfreq(n, d=1.0 / n, device=device) * 2 * math.pi
    kx, ky, kz = torch.meshgrid(k, k, k, indexing="ij")
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    return kx, ky, kz, torch.where(k2 == 0, 1.0, k2)


def _project(uh, kx, ky, kz, k2):
    """Leray projection onto divergence-free fields."""
    div = kx * uh[0] + ky * uh[1] + kz * uh[2]
    return torch.stack([uh[0] - kx * div / k2, uh[1] - ky * div / k2, uh[2] - kz * div / k2])


def _ddx(f_hat, kvec):
    """d/dk of a 3-D field from its spectrum (axes 0, 1, 2 of the field)."""
    return torch.fft.ifftn(1j * kvec * f_hat, dim=(0, 1, 2)).real


def _rhs(uh, chi, cfg, kx, ky, kz, k2):
    u = torch.fft.ifftn(uh, dim=(1, 2, 3)).real
    # advection (u . grad) u, derivatives in spectral space
    adv = []
    for i in range(3):
        gx = _ddx(uh[i], kx)
        gy = _ddx(uh[i], ky)
        gz = _ddx(uh[i], kz)
        adv.append(u[0] * gx + u[1] * gy + u[2] * gz)
    adv = torch.stack(adv)
    # Brinkman: drive velocity to zero inside the solid
    pen = -(chi / cfg.penalization) * u
    rhs = torch.fft.fftn(-adv + pen, dim=(1, 2, 3))
    return _project(rhs, kx, ky, kz, k2)


def _vorticity(uh, kx, ky, kz):
    wx = torch.fft.ifftn(1j * (ky * uh[2] - kz * uh[1]), dim=(0, 1, 2)).real
    wy = torch.fft.ifftn(1j * (kz * uh[0] - kx * uh[2]), dim=(0, 1, 2)).real
    wz = torch.fft.ifftn(1j * (kx * uh[1] - ky * uh[0]), dim=(0, 1, 2)).real
    return torch.sqrt(wx ** 2 + wy ** 2 + wz ** 2)


def simulate(center, cfg: NSConfig = NSConfig(), *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sphere mask [n,n,n], vorticity magnitude [n,n,n,nt]) as
    float32 tensors on ``device`` (default: the card)."""
    device = resolve_device(device)
    center = torch.as_tensor(np.asarray(center, np.float32)).to(device)
    chi = sphere_mask(cfg, center)
    kx, ky, kz, k2 = _wavenumbers(cfg.n, device)
    visc = torch.exp(-cfg.viscosity * k2 * cfg.dt)
    sqrt_visc = torch.sqrt(visc)

    u0 = torch.zeros((3, cfg.n, cfg.n, cfg.n), dtype=torch.float32, device=device)
    u0[0] = cfg.u0
    # small perturbation to break symmetry (jnp.linspace's float32 values)
    ramp = torch.from_numpy(_linspace01(cfg.n)).to(device)
    u0[1] += 0.01 * torch.sin(2 * math.pi * ramp)[None, :, None]
    uh = torch.fft.fftn(u0, dim=(1, 2, 3))
    uh = _project(uh, kx, ky, kz, k2)

    frames = []
    for _ in range(cfg.nt_frames):
        for _ in range(cfg.steps_per_frame):
            r1 = _rhs(uh, chi, cfg, kx, ky, kz, k2)
            mid = (uh + 0.5 * cfg.dt * r1) * sqrt_visc
            r2 = _rhs(mid, chi, cfg, kx, ky, kz, k2)
            uh = (uh + cfg.dt * r2 * sqrt_visc) * visc
        frames.append(_vorticity(uh, kx, ky, kz))
    return chi, torch.stack(frames, dim=-1)  # [n,n,n,nt]


def _linspace01(n: int) -> np.ndarray:
    """``jnp.linspace(0, 1, n)`` in float32: ``i * (1 / (n - 1))`` with the
    last point exactly 1 (``torch.linspace`` rounds its points otherwise)."""
    if n == 1:
        return np.zeros(1, np.float32)
    out = np.arange(n, dtype=np.float32) * np.float32(1.0 / (n - 1))
    out[-1] = 1.0
    return out


def simulate_task(center_tuple, n: int = 32, nt: int = 8, device=None):
    """Top-level picklable entry for the cloud batch API: (mask, vorticity)
    as numpy arrays, simulated on ``device`` (default: the card)."""
    cfg = NSConfig(n=n, nt_frames=nt)
    with torch.no_grad():
        chi, vort = simulate(center_tuple, cfg, device=device)
    return chi.cpu().numpy(), vort.cpu().numpy()
