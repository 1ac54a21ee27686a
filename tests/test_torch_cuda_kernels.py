"""The port's CUDA spectral kernels on the card (``cuda`` marker).

The kernels have no CPU mode, so these tests skip without a card; on the
machine with one they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

They import no JAX: each kernel, and the fused op's backward, is held
against its plain PyTorch version (plain autograd for the backward) on the
same inputs. Gate: rtol=1e-4, atol=1e-5.
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
    spectral_fused_dw,
    spectral_fused_dw_cuda,
    spectral_fused_dw_ref,
)
from repro_torch.train.train_loop import accumulate_grads

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


# (name, dims, x time bins, g time bins, kt, permuted): permuted operands
# have t outermost, as cuFFT's rfftn hands x over
DW_CASES = [
    ("NNN-tails", [(6, 4), (4, 2), (4, 4)], 5, 4, 3, False),
    ("NNN-permuted", [(6, 4), (4, 2), (4, 4)], 3, 5, 3, True),
    ("N--", [(8, 4), (None, 3), (None, 2)], 4, 2, 2, False),
    ("N-N-permuted", [(6, 4), (None, 3), (4, 2)], 3, 5, 3, True),
]


def _permuted(z):
    """The same values with t outermost in memory."""
    return z.permute(5, 0, 1, 2, 3, 4).contiguous().permute(1, 2, 3, 4, 5, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dims,t_x,t_g,kt,permuted", DW_CASES, ids=[c[0] for c in DW_CASES])
def test_dw_kernel_matches_plain(cuda, name, dims, t_x, t_g, kt, permuted):
    rng = np.random.default_rng(len(name) + 20)
    trunc = tuple(n for n, _ in dims)
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    xf = _cplx(rng, (5, 3) + ext + (t_x,), cuda)
    g = _cplx(rng, (5, 4) + ext + (t_g,), cuda)
    if permuted:
        xf, g = _permuted(xf), _permuted(g)
        assert not xf.is_contiguous()
    before = spectral_fused_dw_cuda.launches
    got = spectral_fused_dw(xf, g, trunc, kept)
    torch.cuda.synchronize()
    assert spectral_fused_dw_cuda.launches == before + 1
    torch.testing.assert_close(got, spectral_fused_dw_ref(xf, g, trunc, kept), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dims,t_in,kt,t_out,with_add", CASES, ids=[c[0] for c in CASES])
def test_fused_backward_matches_plain_autograd(cuda, name, dims, t_in, kt, t_out, with_add):
    """dx (the fused kernel on conj(W^T)), dW (the dW kernel) and d add of
    the autograd Function on the card vs autograd through the plain
    version, through the same real loss."""
    rng = np.random.default_rng(len(name) + 30)
    trunc = tuple(n for n, _ in dims)
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    inputs = [_cplx(rng, (3, 3) + ext + (t_in,), cuda), _cplx(rng, (3, 4) + kept, cuda)]
    if with_add:
        inputs.append(_cplx(rng, (3, 4) + kept, cuda))
    y_shape = (3, 4) + ext + (kt if t_out is None else t_out,)
    a = torch.from_numpy(rng.standard_normal(y_shape).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal(y_shape).astype(np.float32)).to(cuda)

    def grads(plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        if plain:
            y = spectral_apply_fused_ref(leaves[0], leaves[1], trunc, t_out)
            if with_add:
                y = y + pad_kept_ref(leaves[2], trunc, t_out)
        elif with_add:
            y = spectral_apply_fused_add(*leaves, trunc, t_out=t_out)
        else:
            y = spectral_apply_fused(*leaves, trunc, t_out=t_out)
        (y.real * a + y.imag * c).sum().backward()
        return [t.grad for t in leaves]

    fused, dw = spectral_fused_cuda.launches, spectral_fused_dw_cuda.launches
    got = grads(plain=False)
    torch.cuda.synchronize()
    assert spectral_fused_cuda.launches == fused + 2  # forward and dx
    assert spectral_fused_dw_cuda.launches == dw + 1
    for g, w in zip(got, grads(plain=True)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_fno_gradients_on_card_match_unfused(cuda):
    """Every leaf's gradient through the fused forward (kernels in the
    forward, the remat recompute and the backward) vs the unfused forward
    on the same card, through the train loop's per-block views."""
    cfg = fno.FNOConfig(grid=(16, 8, 8, 10), modes=(4, 2, 2, 3), width=6,
                        n_blocks=2, decoder_dim=8)
    params = fno.init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    batch = {"x": torch.randn((2, 1) + cfg.grid, device=cuda),
             "y": torch.randn((2, 1) + cfg.grid, device=cuda)}
    out = []
    for forward in (fno.fno_forward, fno.fno_forward_unfused):
        grads = {k: {n: torch.zeros_like(t) for n, t in v.items()} for k, v in params.items()}
        before = spectral_fused_cuda.launches
        accumulate_grads(lambda p, b: (fno.mse_loss(forward(p, b["x"], cfg), b["y"]), {}),
                         params, batch, grads)
        out.append((grads, spectral_fused_cuda.launches - before))
    assert out[0][1] == 3 * cfg.n_blocks and out[1][1] == 0
    for k, v in out[1][0].items():
        for n, want in v.items():
            torch.testing.assert_close(out[0][0][k][n], want, rtol=RTOL, atol=ATOL)
