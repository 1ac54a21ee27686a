"""The port's CUDA spectral kernel on the card (``cuda`` marker).

The kernel has no CPU mode, so these tests skip without a card; on the
machine with one they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

They import no JAX: the kernel is held against its plain PyTorch version on
the same inputs. Gate: rtol=1e-4, atol=1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fno
from repro_torch.kernels.spectral_conv import (
    pad_kept_ref,
    spectral_apply_fused,
    spectral_apply_fused_add,
    spectral_apply_fused_ref,
    spectral_fused_cuda,
)

RTOL, ATOL = 1e-4, 1e-5

# (name, dims [(N or None, K)], t_in, kt, t_out, add)
CASES = [
    ("NNN-tail", [(6, 4), (4, 2), (4, 4)], 5, 3, 5, False),
    ("NNN-add", [(6, 2), (5, 4), (3, 2)], 3, 3, None, True),
    ("N--tail-add", [(8, 4), (None, 3), (None, 2)], 4, 2, 6, True),
    ("N-N-tail", [(6, 4), (None, 3), (4, 2)], 4, 3, 4, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _cplx(rng, shape, dev):
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(z).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dims,t_in,kt,t_out,with_add", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, dims, t_in, kt, t_out, with_add):
    rng = np.random.default_rng(len(name))
    trunc = tuple(n for n, _ in dims)
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    xf = _cplx(rng, (5, 3) + ext + (t_in,), cuda)  # b=5 spans two batch chunks
    w = _cplx(rng, (3, 4) + kept, cuda)
    add = _cplx(rng, (5, 4) + kept, cuda) if with_add else None
    before = spectral_fused_cuda.launches
    got = (spectral_apply_fused_add(xf, w, add, trunc, t_out=t_out) if with_add
           else spectral_apply_fused(xf, w, trunc, t_out=t_out))
    torch.cuda.synchronize()
    assert spectral_fused_cuda.launches == before + 1
    ref = spectral_apply_fused_ref(xf, w, trunc, t_out)
    if with_add:
        ref = ref + pad_kept_ref(add, trunc, t_out)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_fused_forward_matches_unfused_on_card(cuda):
    """The served forward (kernel in every block, x in cuFFT's layout) vs
    the unfused oracle on the same card."""
    cfg = fno.FNOConfig(grid=(16, 8, 8, 10), modes=(4, 2, 2, 3), width=6,
                        n_blocks=2, decoder_dim=8)
    params = fno.init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    x = torch.randn((3, 1) + cfg.grid, device=cuda)
    before = spectral_fused_cuda.launches
    with torch.inference_mode():
        got = fno.fno_forward(params, x, cfg)
        want = fno.fno_forward_unfused(params, x, cfg)
    assert spectral_fused_cuda.launches == before + cfg.n_blocks
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
