"""The port's CUDA spectral kernels on the card (``cuda`` marker).

The kernels have no CPU mode, so these tests skip without a card; on the
machine with one they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

They import no JAX: each kernel, and the backward of the fused and the
flattened-K op, is held against its plain PyTorch version (plain autograd
for the backward) on the same inputs. Gate: rtol=1e-4, atol=1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fno
from repro_torch.kernels.spectral_conv import (
    pad_kept_ref,
    spectral_apply,
    spectral_apply_cuda,
    spectral_apply_dw,
    spectral_apply_dx,
    spectral_apply_fused,
    spectral_apply_fused_add,
    spectral_apply_fused_ref,
    spectral_apply_ref,
    spectral_dw_cuda,
    spectral_dw_ref,
    spectral_fused_cuda,
    spectral_fused_dw,
    spectral_fused_dw_cuda,
    spectral_fused_dw_ref,
    spectral_fused_dx,
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


# (b, ci, co, modes, channels outermost): 2-4 mode dims, K not a multiple of
# 32 or 128, ragged channel tiles, b past the kernels' batch chunk of 4
FLAT_CASES = [
    (1, 3, 5, (7, 19), False),
    (2, 9, 10, (3, 5, 11), True),
    (3, 4, 17, (2, 3, 5, 7), False),
    (6, 11, 9, (3, 33), True),
    (2, 40, 40, (6, 4, 4, 10), True),
]


def _channels_outermost(z):
    return z.transpose(0, 1).contiguous().transpose(0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,modes,permuted", FLAT_CASES)
def test_flat_kernels_match_plain(cuda, b, ci, co, modes, permuted):
    """The mix kernel (forward and dx on conj(W^T)) and the weight-cotangent
    kernel vs their plain versions; repeated dW runs agree bitwise."""
    rng = np.random.default_rng(sum(modes) + b)
    x = _cplx(rng, (b, ci) + modes, cuda)
    w = _cplx(rng, (ci, co) + modes, cuda)
    g = _cplx(rng, (b, co) + modes, cuda)
    if permuted:
        x, w, g = _channels_outermost(x), _channels_outermost(w), _channels_outermost(g)
    before = (spectral_apply_cuda.launches, spectral_dw_cuda.launches)
    y = spectral_apply(x, w)
    dx = spectral_apply_dx(g, w)
    dw = spectral_apply_dw(x, g)
    dw_again = spectral_apply_dw(x, g)
    torch.cuda.synchronize()
    assert (spectral_apply_cuda.launches, spectral_dw_cuda.launches) == (before[0] + 2, before[1] + 2)
    torch.testing.assert_close(y, spectral_apply_ref(x, w), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dx, spectral_apply_ref(g, w.transpose(0, 1).conj()), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dw, spectral_dw_ref(x, g), rtol=RTOL, atol=ATOL)
    assert torch.equal(dw, dw_again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,modes,permuted", FLAT_CASES[:3])
def test_flat_backward_matches_plain_autograd(cuda, b, ci, co, modes, permuted):
    """dx and dW of the flattened-K op's autograd Function on the kernels vs
    autograd through the plain version, through the same real loss; one
    launch of the mix kernel per forward, one more and one of the dW kernel
    per backward."""
    rng = np.random.default_rng(sum(modes) + b + 40)
    inputs = [_cplx(rng, (b, ci) + modes, cuda), _cplx(rng, (ci, co) + modes, cuda)]
    if permuted:
        inputs = [_channels_outermost(t) for t in inputs]
    a = torch.from_numpy(rng.standard_normal((b, co) + modes).astype(np.float32)).to(cuda)

    def grads(plain):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y = (spectral_apply_ref if plain else spectral_apply)(*leaves)
        (y.real * a - y.imag * a).sum().backward()
        return [t.grad for t in leaves]

    before = (spectral_apply_cuda.launches, spectral_dw_cuda.launches)
    got = grads(plain=False)
    torch.cuda.synchronize()
    assert (spectral_apply_cuda.launches, spectral_dw_cuda.launches) == (before[0] + 2, before[1] + 1)
    for g, w in zip(got, grads(plain=True)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_flat_kernel_matches_fused_kernel_on_pretruncated_modes(cuda):
    """At 4 mode dims the mix kernel and the fused kernel with every dim
    pre-truncated and no t padding compute the same function."""
    rng = np.random.default_rng(7)
    x = _cplx(rng, (2, 5, 6, 4, 3, 5), cuda)
    w = _cplx(rng, (5, 7, 6, 4, 3, 5), cuda)
    torch.testing.assert_close(spectral_apply(x, w), spectral_apply_fused(x, w, (None, None, None)),
                               rtol=RTOL, atol=ATOL)


# the fused kernel's edges: kept-mode counts around its 128-thread mix
# blocks (126, 128, 144, 258, 260) and ragged 8-channel tiles; every trunc
# pattern, t tails, add, b = 1-5, x in the layout cuFFT's rfftn returns.
# (name, b, ci, co, dims [(N or None, K)], t_in, kt, t_out, add, x from rfftn)
FUSED_EDGES = [
    ("K=128 NNN co=8", 1, 3, 8, [(8, 4), (8, 4), (4, 2)], 9, 4, 9, False, False),
    ("K=126 N-- co=9", 2, 5, 9, [(6, 2), (None, 1), (None, 63)], 3, 1, 3, False, False),
    ("K=260 N-N tail add", 3, 4, 17, [(10, 2), (None, 65), (4, 2)], 6, 1, 8, True, False),
    ("K=258 N-- b=5 rfftn", 5, 6, 7, [(6, 2), (None, 129), (None, 1)], 6, 1, 6, False, True),
    ("K=144 NNN b=4 add rfftn", 4, 9, 16, [(12, 4), (10, 6), (8, 2)], 7, 3, 7, True, True),
]


def _fused_inputs(rng, b, ci, co, dims, t_in, kt, with_add, from_fft, dev):
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    if from_fft:  # cuFFT returns the spectrum with permuted strides
        real = rng.standard_normal((b, ci) + ext + (2 * (t_in - 1),)).astype(np.float32)
        xf = torch.fft.rfftn(torch.from_numpy(real).to(dev), dim=(2, 3, 4, 5))
    else:
        xf = _cplx(rng, (b, ci) + ext + (t_in,), dev)
    add = _cplx(rng, (b, co) + kept, dev) if with_add else None
    return xf, _cplx(rng, (ci, co) + kept, dev), add


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,ci,co,dims,t_in,kt,t_out,with_add,from_fft", FUSED_EDGES,
                         ids=[c[0] for c in FUSED_EDGES])
def test_fused_kernel_at_tile_edges(cuda, name, b, ci, co, dims, t_in, kt, t_out, with_add,
                                    from_fft):
    """One launch per call, the plain version's result, and the same bits
    on a second run (fixed-order sums, no atomics)."""
    rng = np.random.default_rng(len(name) + 50)
    trunc = tuple(n for n, _ in dims)
    xf, w, add = _fused_inputs(rng, b, ci, co, dims, t_in, kt, with_add, from_fft, cuda)

    def run():
        if with_add:
            return spectral_apply_fused_add(xf, w, add, trunc, t_out=t_out)
        return spectral_apply_fused(xf, w, trunc, t_out=t_out)

    before = spectral_fused_cuda.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    assert spectral_fused_cuda.launches == before + 2
    assert torch.equal(got, again)
    ref = spectral_apply_fused_ref(xf, w, trunc, t_out)
    if with_add:
        ref = ref + pad_kept_ref(add, trunc, t_out)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name,dims,t_g,kt,t_x", [
    ("NNN", [(8, 4), (6, 2), (4, 4)], 5, 3, 7),
    ("N--", [(8, 2), (None, 5), (None, 3)], 4, 2, 4),
    ("N-N", [(6, 4), (None, 3), (10, 2)], 6, 3, 6),
], ids=["NNN", "N--", "N-N"])
def test_fused_dx_on_conj_transpose(cuda, b, name, dims, t_g, kt, t_x):
    """dx: the fused kernel on the cotangent g (in the layout the irfftn
    backward hands over) with conj(W^T) read through swapped strides,
    padded to x's t extent; 9 output channels, so one tile is ragged."""
    rng = np.random.default_rng(b + len(name) + 60)
    trunc = tuple(n for n, _ in dims)
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    g = _permuted(_cplx(rng, (b, 5) + ext + (t_g,), cuda))
    w = _cplx(rng, (9, 5) + kept, cuda)
    before = spectral_fused_cuda.launches
    got, again = spectral_fused_dx(g, w, trunc, t_x), spectral_fused_dx(g, w, trunc, t_x)
    torch.cuda.synchronize()
    assert spectral_fused_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = spectral_apply_fused_ref(g, w.transpose(0, 1).conj(), trunc, t_x)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
