"""Fourier Neural Operator — serial forward for serving (paper Alg. 1).

Port of the serial half of ``repro.core.fno``. Parameters are a nested dict
of tensors with the reference's leaf names (``encoder.w/b``,
``blocks.w_spec`` complex64 ``[n_blocks, w, w, 2mx, 2my, 2mz, mt]``,
``blocks.w_bypass/b_bypass``, ``decoder.w1/b1/w2/b2``), so weights carry
across through numpy (``params_from_numpy`` / ``params_to_numpy``).

Architecture: 1x1-conv encoder -> n_blocks x [spectral conv + 1x1 bypass,
GELU] -> 2-layer decoder. Every block runs the fused spectral op
(truncate + complex channel mix + zero-pad in one pass: the CUDA kernel on
the card, its plain version on the CPU). ``fno_forward_unfused`` is the
unfused oracle (truncate, einsum, pad as three steps) that serving's
``--verify`` replays through. The 1x1 convs and the FFTs stay library
calls (``torch.matmul``, ``torch.fft``), as the reference leaves them to XLA.

Every GELU is the tanh form, as ``jax.nn.gelu``'s default: the exact erf
form differs by up to ~2e-4, outside the 1e-4 parity gate. TF32 stays off:
the 1x1 convs are float32 matrix products at full precision.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.core import dfft
from repro_torch.kernels.spectral_conv import (
    spectral_apply_fused,
    spectral_apply_fused_add,
    spectral_apply_ref,
    spectral_static_contribution,
)

# Spatial positions per decoder chunk: the decoder widens to decoder_dim
# channels, so it runs over slices of the grid to keep that hidden tensor
# small (the decoder is pointwise in space, so chunking changes nothing).
DECODER_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class FNOConfig:
    grid: Tuple[int, int, int, int]  # (nx, ny, nz, nt) of the solution tensor
    modes: Tuple[int, int, int, int]  # (mx, my, mz, mt); 2m kept per full dim
    width: int = 32
    in_channels: int = 1
    out_channels: int = 1
    n_blocks: int = 4
    decoder_dim: int = 128
    # Compute dtype for pointwise/conv ops; the FFT path is always float32.
    dtype: torch.dtype = torch.float32

    @property
    def mode_shape(self) -> Tuple[int, int, int, int]:
        mx, my, mz, mt = self.modes
        return (2 * mx, 2 * my, 2 * mz, mt)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shapes(cfg: FNOConfig) -> dict:
    """Leaf shapes of ``init_params(cfg)``, without allocating."""
    w, nb = cfg.width, cfg.n_blocks
    return {
        "encoder": {"w": (cfg.in_channels, w), "b": (w,)},
        "blocks": {
            "w_spec": (nb, w, w) + cfg.mode_shape,
            "w_bypass": (nb, w, w),
            "b_bypass": (nb, w),
        },
        "decoder": {
            "w1": (w, cfg.decoder_dim),
            "b1": (cfg.decoder_dim,),
            "w2": (cfg.decoder_dim, cfg.out_channels),
            "b2": (cfg.out_channels,),
        },
    }


def init_params(
    cfg: FNOConfig, *, generator: Optional[torch.Generator] = None, device=None
) -> dict:
    """Random parameters with the reference's layout and scales: uniform in
    ±scale (1/width² for the spectral weights, 1/sqrt(fan_in) otherwise),
    zero biases. ``generator`` must live on ``device``; default: seed 0.
    The complex weights are filled in place through their real view, so no
    second copy of the largest tensor is ever made."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    shapes = param_shapes(cfg)
    w = cfg.width

    def uniform(shape, scale):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        return t.uniform_(-scale, scale, generator=g)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    w_spec = torch.empty(shapes["blocks"]["w_spec"], dtype=torch.complex64, device=dev)
    torch.view_as_real(w_spec).uniform_(-1.0 / (w * w), 1.0 / (w * w), generator=g)
    return {
        "encoder": {
            "w": uniform(shapes["encoder"]["w"], (1.0 / cfg.in_channels) ** 0.5),
            "b": zeros(shapes["encoder"]["b"]),
        },
        "blocks": {
            "w_spec": w_spec,
            "w_bypass": uniform(shapes["blocks"]["w_bypass"], (1.0 / w) ** 0.5),
            "b_bypass": zeros(shapes["blocks"]["b_bypass"]),
        },
        "decoder": {
            "w1": uniform(shapes["decoder"]["w1"], (1.0 / w) ** 0.5),
            "b1": zeros(shapes["decoder"]["b1"]),
            "w2": uniform(shapes["decoder"]["w2"], (1.0 / cfg.decoder_dim) ** 0.5),
            "b2": zeros(shapes["decoder"]["b2"]),
        },
    }


def params_from_numpy(tree: dict, device=None) -> dict:
    """Nested dict of numpy arrays (the reference's params pytree, e.g. via
    ``jax.device_get``) -> the same dict of tensors on ``device``. A
    contiguous, writable array is not copied on the host."""
    dev = resolve_device(device)
    return _tree_map(
        lambda a: torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev),
        tree,
    )


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: the same leaves as numpy arrays."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), params)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _conv1x1(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Channel-mixing 1x1 conv on [b, c, x, y, z, t]: one matrix product per
    batch row over the flattened grid."""
    bsz, c = x.shape[:2]
    y = torch.matmul(w.t().to(x.dtype), x.reshape(bsz, c, -1))
    y = y.reshape((bsz, w.shape[1]) + tuple(x.shape[2:]))
    if b is not None:
        y += b.to(x.dtype).view(1, -1, 1, 1, 1, 1)
    return y


def _encoder(params: dict, x: torch.Tensor, cfg: FNOConfig) -> torch.Tensor:
    x = x.to(cfg.dtype)
    return _gelu(_conv1x1(x, params["encoder"]["w"], params["encoder"]["b"]))


def encoder_prelift(params: dict, x: torch.Tensor, cfg: FNOConfig, channels=None) -> torch.Tensor:
    """Partial pre-activation lift of a channel SLICE of the input.

    The encoder's 1x1 conv is linear in x, so the lift of the static
    (geomodel) channels and that of the dynamic channels can be computed
    apart and summed before bias + GELU — what lets serving cache the
    static lift. ``x``: [b, c_sub, nx, ny, nz, nt] matching ``channels``
    (a slice into ``in_channels``; default all). Returns [b, width, ...]
    without bias or GELU.
    """
    w = params["encoder"]["w"]
    if channels is not None:
        w = w[channels]
    return _conv1x1(x.to(cfg.dtype), w, None)


def _encoder_from_prelift(params: dict, pre: torch.Tensor, cfg: FNOConfig) -> torch.Tensor:
    """bias + GELU over a (summed) pre-activation lift."""
    b = params["encoder"]["b"].to(pre.dtype)
    return _gelu(pre + b.view(1, -1, 1, 1, 1, 1))


def _decoder(params: dict, x: torch.Tensor, cfg: FNOConfig) -> torch.Tensor:
    d = params["decoder"]
    bsz, c = x.shape[:2]
    flat = x.reshape(bsz, c, -1)
    n = flat.shape[-1]
    out = torch.empty((bsz, cfg.out_channels, n), dtype=x.dtype, device=x.device)
    w1, w2 = d["w1"].t().to(x.dtype), d["w2"].t().to(x.dtype)
    b1 = d["b1"].to(x.dtype).view(1, -1, 1)
    b2 = d["b2"].to(x.dtype).view(1, -1, 1)
    for s in range(0, n, DECODER_CHUNK):
        h = _gelu(torch.matmul(w1, flat[..., s:s + DECODER_CHUNK]) + b1)
        out[..., s:s + DECODER_CHUNK] = torch.matmul(w2, h) + b2
    return out.reshape((bsz, cfg.out_channels) + tuple(x.shape[2:])).to(torch.float32)


def _block_slice(blocks: dict, i: int) -> dict:
    return {k: v[i] for k, v in blocks.items()}


def fno_block(x, w_spec, w_b, b_b, cfg: FNOConfig, *, add_kept=None, bypass_x=None):
    """Serial FNO block: irfftn(fused S^T W S (rfftn(x))) + bypass, GELU.

    The FFT layer neither truncates nor pads: the fused spectral op does,
    so the mode tensor crosses device memory once. Deep-split serving
    (``fno_forward_deep_split``) passes ``add_kept``, a cached kept-mode
    contribution summed into the spectral output, and ``bypass_x``, the
    full activation the 1x1 bypass runs on when ``x`` is only the dynamic
    remainder. Intermediates are dropped as soon as they are used, since
    at serving size each one is several GB.
    """
    nx, ny, nz, nt = cfg.grid
    xf = dfft.serial_forward(x, cfg.modes, truncate=False)
    if add_kept is None:
        yf = spectral_apply_fused(xf, w_spec, (nx, ny, nz), t_out=nt // 2 + 1)
    else:
        yf = spectral_apply_fused_add(
            xf, w_spec, add_kept, (nx, ny, nz), t_out=nt // 2 + 1
        )
    del xf
    y = dfft.serial_adjoint(yf, cfg.grid, out_dtype=cfg.dtype, pre_padded=True)
    del yf
    y += _conv1x1(x if bypass_x is None else bypass_x, w_b, b_b)
    return _gelu(y)


def _fno_block_unfused(x, w_spec, w_b, b_b, cfg: FNOConfig):
    """The unfused block: truncate, channel mix, pad as separate steps."""
    xf = dfft.serial_forward(x, cfg.modes)
    yf = spectral_apply_ref(xf, w_spec)
    y = dfft.serial_adjoint(yf, cfg.grid, out_dtype=cfg.dtype)
    y += _conv1x1(x, w_b, b_b)
    return _gelu(y)


def _run_blocks(params: dict, h: torch.Tensor, cfg: FNOConfig, block_apply, first: int = 0):
    """Shared tail of every forward: the FNO blocks from ``first`` on, then
    the decoder. ``block_apply(h, blk)`` applies one block's params."""
    blocks = params["blocks"]
    for i in range(first, blocks["w_spec"].shape[0]):
        h = block_apply(h, _block_slice(blocks, i))
    return _decoder(params, h, cfg)


def _fused_block(cfg):
    return lambda h, blk: fno_block(h, blk["w_spec"], blk["w_bypass"], blk["b_bypass"], cfg)


def fno_forward(params: dict, x: torch.Tensor, cfg: FNOConfig) -> torch.Tensor:
    """Single-device forward. x: [b, c_in, nx, ny, nz, nt] -> [b, c_out, ...]."""
    return _run_blocks(params, _encoder(params, x, cfg), cfg, _fused_block(cfg))


def fno_forward_unfused(params: dict, x: torch.Tensor, cfg: FNOConfig) -> torch.Tensor:
    """The unfused serial oracle (the reference's ``use_pallas=False``
    branch): no fused kernel anywhere, so checking served outputs against
    it is a fused-vs-unfused gate, not a self-comparison."""
    return _run_blocks(
        params, _encoder(params, x, cfg), cfg,
        lambda h, blk: _fno_block_unfused(
            h, blk["w_spec"], blk["w_bypass"], blk["b_bypass"], cfg
        ),
    )


def fno_forward_split(
    params: dict, pre_static: torch.Tensor, x_dyn: torch.Tensor, cfg: FNOConfig, n_static: int
) -> torch.Tensor:
    """Forward from a precomputed static-channel prelift.

    ``pre_static``: [b, width, ...] — the cached partial lift of the first
    ``n_static`` (normalized) input channels. ``x_dyn``: [b, in_channels -
    n_static, ...] — the normalized dynamic channels, lifted here. Equal to
    ``fno_forward`` on the concatenated input up to summation order.
    """
    pre = pre_static.to(cfg.dtype) + encoder_prelift(
        params, x_dyn, cfg, slice(n_static, None)
    )
    h = _encoder_from_prelift(params, pre, cfg)
    del pre
    return _run_blocks(params, h, cfg, _fused_block(cfg))


def spectral_prelift(params: dict, pre_static: torch.Tensor, cfg: FNOConfig):
    """Static prefix of the FIRST spectral block, computed once per geomodel.

    With ``h = h_static + h_rem`` and ``h_static = GELU(pre_static + b)``,
    FFT -> truncate -> mix is linear, so block 0's kept-mode output is
    ``W_0 . S(h_rem) + W_0 . S(h_static)``; the second term is cacheable.
    ``pre_static``: [b, width, nx, ny, nz, nt] (or unbatched). Returns
    ``(spectra, contribution)``: S(h_static) and W_0 . S(h_static),
    both [.., width, 2mx, 2my, 2mz, mt].
    """
    unbatched = pre_static.ndim == 5
    if unbatched:
        pre_static = pre_static[None]
    h_s = _encoder_from_prelift(params, pre_static.to(cfg.dtype), cfg)
    spectra = dfft.serial_forward(h_s, cfg.modes)
    contrib = spectral_static_contribution(spectra, params["blocks"]["w_spec"][0])
    if unbatched:
        spectra, contrib = spectra[0], contrib[0]
    return spectra, contrib


def fno_forward_deep_split(
    params: dict,
    contrib: torch.Tensor,
    pre_static: torch.Tensor,
    x_dyn: torch.Tensor,
    cfg: FNOConfig,
    n_static: int,
) -> torch.Tensor:
    """Forward from a cached prelift AND a cached first-block static
    contribution (``spectral_prelift``).

    ``contrib``: [b, width, 2mx, 2my, 2mz, mt] complex — ``W_0 . S(h_static)``.
    Block 0 runs on the dynamic remainder ``h - h_static`` with the cached
    term summed into its spectral output (the bypass sees the full ``h``);
    the other blocks are unchanged. Equal to ``fno_forward_split`` up to
    summation order.
    """
    pre_s = pre_static.to(cfg.dtype)
    h_static = _encoder_from_prelift(params, pre_s, cfg)
    pre = pre_s + encoder_prelift(params, x_dyn, cfg, slice(n_static, None))
    h_full = _encoder_from_prelift(params, pre, cfg)
    del pre
    h_rem = h_full - h_static
    del h_static
    blk0 = _block_slice(params["blocks"], 0)
    h = fno_block(
        h_rem, blk0["w_spec"], blk0["w_bypass"], blk0["b_bypass"], cfg,
        add_kept=contrib.to(torch.complex64).contiguous(), bypass_x=h_full,
    )
    del h_rem, h_full
    return _run_blocks(params, h, cfg, _fused_block(cfg), first=1)
