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


# (name, b, ci, co, dims, x time bins, g time bins, kt, layout). Layouts:
# "contiguous"; "permuted", both operands t outermost; "fft", x from rfftn
# and g from the irfftn backward, as training hands them over. The kernel
# tiles 40 ci x 40 co x a box of kept modes that is one run of w: whole
# (k3, kt) planes of a few (k1, k2) rows, else a run of k3, else of kt.
DW_CASES = [
    ("NNN-tails", 5, 3, 4, [(6, 4), (4, 2), (4, 4)], 5, 4, 3, "contiguous"),
    ("NNN-permuted", 5, 3, 4, [(6, 4), (4, 2), (4, 4)], 3, 5, 3, "permuted"),
    ("N--", 5, 3, 4, [(8, 4), (None, 3), (None, 2)], 4, 2, 2, "contiguous"),
    ("N-N-permuted", 5, 3, 4, [(6, 4), (None, 3), (4, 2)], 3, 5, 3, "permuted"),
    ("NNN-fft-channels-41x45-b1", 1, 41, 45, [(8, 4), (6, 2), (6, 4)], 4, 4, 3, "fft"),
    ("N---fft-K3-7-kt5-b6", 6, 3, 4, [(8, 4), (None, 3), (None, 7)], 6, 5, 5, "fft"),
    ("N--permuted-K3-5-kt1-b6", 6, 5, 3, [(6, 4), (None, 2), (None, 5)], 3, 2, 1, "permuted"),
    ("N-N-fft-kt1-b1", 1, 5, 3, [(6, 4), (None, 3), (8, 2)], 3, 5, 1, "fft"),
    ("N-N-fft-kt3-b6", 6, 7, 9, [(10, 6), (None, 3), (6, 4)], 6, 6, 3, "fft"),
    ("N---fft-40x40-k3-runs-b2", 2, 40, 40, [(12, 4), (None, 4), (None, 16)], 11, 11, 10, "fft"),
    ("N--permuted-k3-runs-ragged", 1, 3, 2, [(4, 2), (None, 2), (None, 60)], 10, 10, 10, "permuted"),
    ("N--contiguous-kt-runs", 1, 3, 2, [(4, 2), (None, 2), (None, 2)], 600, 600, 600, "contiguous"),
    ("---permuted-odd-K", 3, 3, 5, [(None, 3), (None, 5), (None, 3)], 5, 6, 5, "permuted"),
    # 768 tiles: more than the card holds blocks, so each block walks several
    ("NNN-fft-40x40-b6-many-tiles", 6, 40, 40, [(16, 16), (16, 16), (8, 8)], 8, 8, 8, "fft"),
]


def _permuted(z):
    """The same values with t outermost in memory."""
    return z.permute(5, 0, 1, 2, 3, 4).contiguous().permute(1, 2, 3, 4, 5, 0)


def _dw_inputs(rng, b, ci, co, ext, t_x, t_g, layout, dev):
    if layout != "fft":
        xf, g = _cplx(rng, (b, ci) + ext + (t_x,), dev), _cplx(rng, (b, co) + ext + (t_g,), dev)
        return (_permuted(xf), _permuted(g)) if layout == "permuted" else (xf, g)
    real = rng.standard_normal((b, ci) + ext + (2 * (t_x - 1),)).astype(np.float32)
    xf = torch.fft.rfftn(torch.from_numpy(real).to(dev), dim=(2, 3, 4, 5))
    yf = torch.zeros((b, co) + ext + (t_g,), dtype=torch.complex64, device=dev,
                     requires_grad=True)
    y = torch.fft.irfftn(yf, s=ext + (2 * (t_g - 1),), dim=(2, 3, 4, 5))
    y.backward(torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32)).to(dev))
    return xf, yf.grad


def _dw_case(case, dev):
    name, b, ci, co, dims, t_x, t_g, kt, layout = case
    rng = np.random.default_rng(len(name) + 20)
    trunc = tuple(n for n, _ in dims)
    ext = tuple(k if n is None else n for n, k in dims)
    kept = tuple(k for _, k in dims) + (kt,)
    xf, g = _dw_inputs(rng, b, ci, co, ext, t_x, t_g, layout, dev)
    if layout == "permuted":
        assert not xf.is_contiguous()
    return xf, g, trunc, kept


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES, ids=[c[0] for c in DW_CASES])
def test_dw_kernel_matches_plain(cuda, case):
    xf, g, trunc, kept = _dw_case(case, cuda)
    before = spectral_fused_dw_cuda.launches
    got = spectral_fused_dw(xf, g, trunc, kept)
    torch.cuda.synchronize()
    assert spectral_fused_dw_cuda.launches == before + 1
    torch.testing.assert_close(got, spectral_fused_dw_ref(xf, g, trunc, kept), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [DW_CASES[9], DW_CASES[13]], ids=[DW_CASES[9][0], DW_CASES[13][0]])
def test_dw_kernel_is_bitwise_repeatable(cuda, case):
    """Fixed-order batch sums and no atomics: two launches on the same
    inputs give the same bits."""
    xf, g, trunc, kept = _dw_case(case, cuda)
    before = spectral_fused_dw_cuda.launches
    got, again = spectral_fused_dw(xf, g, trunc, kept), spectral_fused_dw(xf, g, trunc, kept)
    torch.cuda.synchronize()
    assert spectral_fused_dw_cuda.launches == before + 2
    assert torch.equal(got, again)


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
# 32 or 128, ragged channel tiles, b past the kernels' batch chunk of 4; K at
# the mix kernel's 64-mode tile and its 16-byte pair edges (K = 63, 64, 65,
# 1, 2: an odd K takes its 8-byte path), co past its 40-channel chunk, and
# the P = 4 shard's mode shape at reduced channels
FLAT_CASES = [
    (1, 3, 5, (7, 19), False),
    (2, 9, 10, (3, 5, 11), True),
    (3, 4, 17, (2, 3, 5, 7), False),
    (6, 11, 9, (3, 33), True),
    (2, 40, 40, (6, 4, 4, 10), True),
    (2, 7, 40, (63,), False),
    (1, 40, 40, (8, 8), False),
    (2, 5, 6, (5, 13), True),
    (5, 3, 41, (1,), False),
    (2, 3, 81, (2,), False),
    (2, 8, 8, (48, 8, 16, 10), False),
]


def _channels_outermost(z):
    return z.transpose(0, 1).contiguous().transpose(0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,modes,permuted", FLAT_CASES)
def test_flat_kernels_match_plain(cuda, b, ci, co, modes, permuted):
    """The mix kernel (forward and dx on conj(W^T), through swapped weight
    strides) and the weight-cotangent kernel vs their plain versions;
    repeated runs of each agree bitwise."""
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
    assert torch.equal(y, spectral_apply(x, w)) and torch.equal(dx, spectral_apply_dx(g, w))


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


# The 1-D model-parallel blocks' operands at the P = 4 shard (width 40,
# modes (24,16,8,10)) of the served grid 128x64x32x88 (b = 2; eager also at
# a training micro-batch, b = 1) and of the training grid 64x32x32x88
# (b = 1): paper and eager hand the kernel x at full size and y/z/t
# pre-truncated to (8, 16, 10); Grady-31 hands it y pre-truncated only,
# x/z/t full, and pads t to 45.
# (name, b, trunc, x extents, x time bins, t_out)
DIST_SHARDS = [
    ("paper-serve", 2, (128, None, None), (128, 8, 16), 10, None),
    ("eager-serve-b1", 1, (128, None, None), (128, 8, 16), 10, None),
    ("grady31-serve", 2, (128, None, 32), (128, 8, 32), 45, 45),
    ("paper-train", 1, (64, None, None), (64, 8, 16), 10, None),
]
DIST_IDS = [c[0] for c in DIST_SHARDS]
DIST_KEPT = (48, 8, 16, 10)


def _gate(got, ref):
    """The smoke's gate: max|got - ref| <= 1e-4 max|ref| + 1e-6."""
    assert got.shape == ref.shape
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= 1e-4 * scale + 1e-6, f"max|d|={err:.3e}, max|ref|={scale:.3e}"


def _shard_spectrum(gen, shape, dev):
    """A spectrum in the layout the block's x FFT leaves it in."""
    z = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
    return torch.fft.fft(z, dim=2)


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,trunc,ext,t_x,t_out", DIST_SHARDS, ids=DIST_IDS)
def test_fused_kernel_at_dist_shard_shapes(cuda, name, b, trunc, ext, t_x, t_out):
    gen = torch.Generator(device=cuda).manual_seed(DIST_IDS.index(name))
    xf = _shard_spectrum(gen, (b, 40) + ext + (t_x,), cuda)
    w = torch.randn((40, 40) + DIST_KEPT, dtype=torch.complex64, device=cuda, generator=gen)
    before = spectral_fused_cuda.launches
    got = spectral_apply_fused(xf, w, trunc, t_out=t_out)
    again = spectral_apply_fused(xf, w, trunc, t_out=t_out)
    torch.cuda.synchronize()
    assert spectral_fused_cuda.launches == before + 2
    assert torch.equal(got, again)
    _gate(got, spectral_apply_fused_ref(xf, w, trunc, t_out))


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,trunc,ext,t_x,t_out", DIST_SHARDS, ids=DIST_IDS)
def test_fused_dx_at_dist_shard_shapes(cuda, name, b, trunc, ext, t_x, t_out):
    gen = torch.Generator(device=cuda).manual_seed(10 + DIST_IDS.index(name))
    t_g = DIST_KEPT[3] if t_out is None else t_out
    g = _shard_spectrum(gen, (b, 40) + ext + (t_g,), cuda)
    w = torch.randn((40, 40) + DIST_KEPT, dtype=torch.complex64, device=cuda, generator=gen)
    before = spectral_fused_cuda.launches
    got, again = spectral_fused_dx(g, w, trunc, t_x), spectral_fused_dx(g, w, trunc, t_x)
    torch.cuda.synchronize()
    assert spectral_fused_cuda.launches == before + 2
    assert torch.equal(got, again)
    _gate(got, spectral_apply_fused_ref(g, w.transpose(0, 1).conj(), trunc, t_x))


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,trunc,ext,t_x,t_out", DIST_SHARDS, ids=DIST_IDS)
def test_dw_kernel_at_dist_shard_shapes(cuda, name, b, trunc, ext, t_x, t_out):
    gen = torch.Generator(device=cuda).manual_seed(20 + DIST_IDS.index(name))
    t_g = DIST_KEPT[3] if t_out is None else t_out
    xf = _shard_spectrum(gen, (b, 40) + ext + (t_x,), cuda)
    g = _shard_spectrum(gen, (b, 40) + ext + (t_g,), cuda)
    before = spectral_fused_dw_cuda.launches
    got = spectral_fused_dw(xf, g, trunc, DIST_KEPT)
    again = spectral_fused_dw(xf, g, trunc, DIST_KEPT)
    torch.cuda.synchronize()
    assert spectral_fused_dw_cuda.launches == before + 2
    assert torch.equal(got, again)
    _gate(got, spectral_fused_dw_ref(xf, g, trunc, DIST_KEPT))
