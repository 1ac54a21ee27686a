"""Fourier Neural Operator — serial and model-parallel forward and
training (paper Alg. 1 and 2).

Port of ``repro.core.fno``: the serial forwards and the domain-decomposed
ones, 1-D and 2-D pencils. Parameters are a nested dict
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

Every forward is differentiable: the fused op's backward runs on the
kernels too (``kernels/spectral_conv/ops.py``), and with ``cfg.remat``
each block is recomputed in the backward instead of keeping its
intermediates (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``). A trainer may hand the forwards a params tree whose
``blocks`` leaves are lists of per-block tensors instead of stacked
tensors (``train/train_loop.py`` does, so that no gradient of a stacked
leaf is ever formed per block); every forward indexes blocks the same way
in both.

The model-parallel forwards (``make_dist_forward``) run on every rank of
a ``torch.distributed`` process group, the reference's mesh axis: x is
sharded along the solution's x dim over the group and the spectral weights
along k_y (``shard_params``); everything else is replicated. With a pair
of groups (the 2-D pencils) x is sharded over the first and y over the
second, and the weights along k_y over the first and k_z over the second.
Every block runs the same fused op at its shard's shapes, after the
paper's schedule, the eager schedule or (1-D only) Grady et al.'s [31]
(``core/dfft.py``). ``forward_and_specs`` gives a trainer the serial or
the distributed forward with its layouts; ``split_forward_and_specs`` and
``deep_split_forward_and_specs`` give a server the same for the split
forwards, which take a cached static prelift (and, deep, block 0's cached
kept-mode contribution, sharded as ``w_spec`` is: ``contrib_spec``).

Every GELU is the tanh form, as ``jax.nn.gelu``'s default: the exact erf
form differs by up to ~2e-4, outside the 1e-4 parity gate. TF32 stays off:
the 1x1 convs are float32 matrix products at full precision.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import resolve_device
from repro_torch.core import dfft
from repro_torch.core.partition import CartPartition, gather_tree, shard_tree
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
    # Channel-chunk the distributed FFT pipelines: one all-to-all per chunk
    # (bit-identical to one for all channels).
    comm_chunks: int = 1
    remat: bool = True  # recompute each FNO block in the backward

    @property
    def mode_shape(self) -> Tuple[int, int, int, int]:
        mx, my, mz, mt = self.modes
        return (2 * mx, 2 * my, 2 * mz, mt)

    def validate_for_parallelism(self, n_shards: int) -> None:
        """x sharded n_shards ways; the repartition moves the shard onto the
        truncated y dim, hence 2my too."""
        nx = self.grid[0]
        two_my = 2 * self.modes[1]
        if nx % n_shards:
            raise ValueError(f"nx={nx} not divisible by {n_shards} shards")
        if two_my % n_shards:
            raise ValueError(f"2*my={two_my} not divisible by {n_shards} shards")
        self._validate_modes_fit()

    def validate_for_parallelism_2d(self, n_x: int, n_y: int) -> None:
        """Pencil decomposition: x sharded n_x ways, y sharded n_y ways.

        The two repartitions move the x-shard onto the truncated y dim and
        the y-shard onto the truncated z dim, hence the 2my/2mz constraints.
        """
        nx, ny = self.grid[0], self.grid[1]
        two_my, two_mz = 2 * self.modes[1], 2 * self.modes[2]
        if nx % n_x:
            raise ValueError(f"nx={nx} not divisible by {n_x} x-shards")
        if two_my % n_x:
            raise ValueError(f"2*my={two_my} not divisible by {n_x} x-shards")
        if ny % n_y:
            raise ValueError(f"ny={ny} not divisible by {n_y} y-shards")
        if two_mz % n_y:
            raise ValueError(f"2*mz={two_mz} not divisible by {n_y} y-shards")
        self._validate_modes_fit()

    def _validate_modes_fit(self) -> None:
        mx, my, mz, mt = self.modes
        nx, ny, nz, nt = self.grid
        if 2 * mx > nx or 2 * my > ny or 2 * mz > nz or mt > nt // 2 + 1:
            raise ValueError(f"modes {self.modes} exceed grid {self.grid}")


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
    the decoder. ``block_apply(h, blk)`` applies one block's params. Under
    autograd with ``cfg.remat`` each block keeps only its input and is run
    again in the backward; serving (grad off) never checkpoints."""
    blocks = params["blocks"]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(first, len(blocks["w_spec"])):
        blk = _block_slice(blocks, i)
        if remat:
            h = checkpoint(block_apply, h, blk, use_reentrant=False)
        else:
            h = block_apply(h, blk)
    return _decoder(params, h, cfg)


def _fused_block(cfg):
    """``block(h, blk, add_kept=None, bypass_x=None)``: one serial fused block."""
    return lambda h, blk, **kw: fno_block(
        h, blk["w_spec"], blk["w_bypass"], blk["b_bypass"], cfg, **kw)


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
    return _split_forward(params, pre_static, x_dyn, cfg, n_static, _fused_block(cfg))


def _split_forward(params, pre_static, x_dyn, cfg, n_static, block):
    """The split forward's body under ``block`` (serial or one rank's).
    The prelift add and the dynamic channels' lift are pointwise over the
    spatial dims, so on a rank's slab they need no communication."""
    pre = pre_static.to(cfg.dtype) + encoder_prelift(
        params, x_dyn, cfg, slice(n_static, None)
    )
    h = _encoder_from_prelift(params, pre, cfg)
    del pre
    return _run_blocks(params, h, cfg, block)


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
    return _deep_split_forward(params, contrib, pre_static, x_dyn, cfg, n_static,
                               _fused_block(cfg))


def _deep_split_forward(params, contrib, pre_static, x_dyn, cfg, n_static, block):
    """The deep split's body under ``block`` (serial or one rank's, where
    ``contrib`` is the rank's shard of the contribution)."""
    pre_s = pre_static.to(cfg.dtype)
    h_static = _encoder_from_prelift(params, pre_s, cfg)
    pre = pre_s + encoder_prelift(params, x_dyn, cfg, slice(n_static, None))
    h_full = _encoder_from_prelift(params, pre, cfg)
    del pre
    h_rem = h_full - h_static
    del h_static
    h = block(h_rem, _block_slice(params["blocks"], 0),
              add_kept=contrib.to(torch.complex64).contiguous(), bypass_x=h_full)
    del h_rem, h_full
    return _run_blocks(params, h, cfg, block, first=1)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.to(torch.float32) - target.to(torch.float32)))


# ---------------------------------------------------------------------------
# Distributed forward (paper Algorithm 1 + 2). Every rank of the model
# group(s) calls it on its local slices: x [b_local, c, nx/P, ny, nz, nt]
# and w_spec [n_blocks, ci, co, 2mx, 2my/P, 2mz, mt] (1-D), or x
# [b_local, c, nx/Px, ny/Py, nz, nt] and w_spec [.., 2my/Px, 2mz/Py, mt]
# (2-D pencils); everything else replicated. ``model`` is one group (1-D)
# or the pair (mx_group, my_group) of ``launch.mesh.build_fno_groups``.
# ---------------------------------------------------------------------------

# [n_blocks, ci, co, kx, ky, kz, kt]: k_y sharded over the model group; with
# pencils k_y over the mx group and k_z over the my group, the dims each
# shard lands on after the pencil forward's repartitions
W_SPEC_PARTITION = CartPartition((None, None, None, None, "model", None, None))
W_SPEC_PARTITION_2D = CartPartition((None, None, None, None, "mx", "my", None))


def _is_pair(model) -> bool:
    return isinstance(model, (tuple, list))


def model_axes(model):
    """The reference's mesh-axis name(s) of ``model``: "model" for one
    group, ("mx", "my") for a pencil pair, None for None."""
    if model is None:
        return None
    return ("mx", "my") if _is_pair(model) else "model"


def group_names(data_group, model) -> dict:
    """Each group under the name its partitions use: "data", and "model"
    or "mx" and "my"."""
    if model is None:
        return {"data": data_group}
    if _is_pair(model):
        if len(model) != 2:
            raise ValueError(f"expected 2 model groups, got {len(model)}")
        return {"data": data_group, "mx": model[0], "my": model[1]}
    return {"data": data_group, "model": model}


def param_partitions(model) -> dict:
    """The partition of every parameter leaf (None: replicated, the
    paper's broadcast B), the counterpart of the reference's
    ``param_specs``: only ``blocks.w_spec`` is sharded, along k_y (one
    group) or k_y x k_z (a pencil pair); ``model=None`` replicates all."""
    w_spec = None if model is None else (W_SPEC_PARTITION_2D if _is_pair(model)
                                         else W_SPEC_PARTITION)
    return {
        "encoder": {"w": None, "b": None},
        "blocks": {"w_spec": w_spec, "w_bypass": None, "b_bypass": None},
        "decoder": {"w1": None, "b1": None, "w2": None, "b2": None},
    }


def shard_params(params: dict, model) -> dict:
    """This rank's parameters: ``blocks.w_spec`` sliced into the rank's
    k_y run (or k_y x k_z block for a pencil pair; a copy), every other
    leaf the same tensor (replicated)."""
    return shard_tree(params, param_partitions(model), group_names(None, model))


def gather_params(params: dict, model) -> dict:
    """Inverse of ``shard_params`` (a collective over the model group(s)):
    the global ``w_spec`` from every rank's slice; the other leaves as
    they are."""
    return gather_tree(params, param_partitions(model), group_names(None, model))


def contrib_spec(data_axis: Optional[str] = "data", model_axis="model") -> CartPartition:
    """Partition of the cached kept-mode contribution [b, co, 2mx, 2my,
    2mz, mt]: batch over the data group, k_y over the model group (as
    ``w_spec``: the contribution is a per-mode product with it), or k_y
    and k_z over a pencil pair (``model_axis=None``: batch only)."""
    if _is_pair(model_axis):
        ax_x, ax_y = model_axis
        return CartPartition((data_axis, None, None, ax_x, ax_y, None))
    return CartPartition((data_axis, None, None, model_axis, None, None))


def input_spec(data_axis: Optional[str] = "data", model_axis="model") -> CartPartition:
    """Partition of the solution tensor [b, c, x, y, z, t]: batch over the
    data group, x over the model group, or x and y over a pencil pair of
    names (``model_axis=None``: batch only). The layout
    ``make_dist_forward`` takes and returns."""
    if _is_pair(model_axis):
        ax_x, ax_y = model_axis
        return CartPartition((data_axis, None, ax_x, ax_y, None, None))
    return CartPartition((data_axis, None, model_axis, None, None, None))


# (variant, decomposition): (forward transform, its adjoint, whether z and
# t reach the fused op untruncated). Every transform leaves x full size:
# the fused op truncates it and pads it back.
_SCHEDULES = {
    # paper Alg. 2: local F/S over yzt, R_{x->y}, F over x
    ("paper", 1): (partial(dfft.dist_forward, trunc_x=False),
                   partial(dfft.dist_adjoint, pad_x=False), False),
    # per-dim eager truncation (beyond the paper; Alg. 2 with cheaper FFTs)
    ("eager", 1): (partial(dfft.dist_forward_eager, trunc_x=False),
                   partial(dfft.dist_adjoint_eager, pad_x=False), False),
    # Grady et al. [31]: repartition the spectrum untruncated along y/z/t
    ("grady31", 1): (partial(dfft.dist_forward_untruncated, trunc_xzt=False),
                     partial(dfft.dist_adjoint_untruncated, pad_xzt=False), True),
    # 2-D pencils: F/S over zt, R^{my}_{y->z}, F/S over y, R^{mx}_{x->y}, F over x
    ("paper", 2): (partial(dfft.dist_forward_2d, trunc_x=False),
                   partial(dfft.dist_adjoint_2d, pad_x=False), False),
    ("eager", 2): (partial(dfft.dist_forward_2d_eager, trunc_x=False),
                   partial(dfft.dist_adjoint_2d_eager, pad_x=False), False),
}


def _variants(n_dims: int) -> list:
    return sorted(v for v, d in _SCHEDULES if d == n_dims)


def fno_block_dist(x, w_spec, w_b, b_b, cfg: FNOConfig, model, variant: str = "paper",
                   *, add_kept=None, bypass_x=None):
    """One FNO block on this rank's x slice (or pencil) under ``variant``'s
    schedule: the forward transform, the fused op (S_x, or S_xzt for
    Grady-31, the per-mode mix with sharded weights, and its zero fill),
    the adjoint transform, the bypass and the GELU.

    ``add_kept`` is this rank's shard of a cached kept-mode contribution
    ([b, co, 2mx, 2my/P, 2mz, mt], or k_y x k_z sharded on pencils:
    ``contrib_spec``), summed into the fused op's output on the kept
    modes; ``bypass_x`` as in ``fno_block``."""
    forward, adjoint, full_zt = _SCHEDULES[variant, 2 if _is_pair(model) else 1]
    nx, _, nz, nt = cfg.grid
    trunc, t_out = ((nx, None, nz), nt // 2 + 1) if full_zt else ((nx, None, None), None)
    xf = forward(x, cfg.modes, model, comm_chunks=cfg.comm_chunks)
    if add_kept is None:
        yf = spectral_apply_fused(xf, w_spec, trunc, t_out=t_out)
    else:
        yf = spectral_apply_fused_add(xf, w_spec, add_kept, trunc, t_out=t_out)
    del xf
    y = adjoint(yf, cfg.grid, model, out_dtype=cfg.dtype, comm_chunks=cfg.comm_chunks)
    del yf
    y += _conv1x1(x if bypass_x is None else bypass_x, w_b, b_b)
    return _gelu(y)


def _dist_block(cfg, model, variant):
    """``block(h, blk, add_kept=None, bypass_x=None)``: one rank's block."""
    return lambda h, blk, **kw: fno_block_dist(
        h, blk["w_spec"], blk["w_bypass"], blk["b_bypass"], cfg, model, variant, **kw)


def fno_forward_dist(params, x, cfg: FNOConfig, model, variant: str = "paper"):
    # The encoder, bypass and decoder contract channels only, so they run
    # on the local x slice with replicated weights (paper Alg. 1).
    return _run_blocks(params, _encoder(params, x, cfg), cfg, _dist_block(cfg, model, variant))


def _check_dist(cfg: FNOConfig, model, variant: str) -> None:
    """The refusals every distributed forward shares: a None group, a
    wrong number of groups, a variant without a schedule for the layout,
    and a grid or modes the shard counts do not divide."""
    if model is None or (_is_pair(model) and None in tuple(model)):
        raise ValueError("a model group is None, which torch.distributed reads as every rank; "
                         "pass the model group(s) build_fno_groups returns")
    if _is_pair(model):
        if len(model) != 2:
            raise ValueError(f"expected 2 model groups, got {len(model)}")
        if (variant, 2) not in _SCHEDULES:
            raise ValueError(f"variant {variant!r} has no 2-D schedule; pick from {_variants(2)}")
        cfg.validate_for_parallelism_2d(*(dist.get_world_size(g) for g in model))
    else:
        if (variant, 1) not in _SCHEDULES:
            raise ValueError(f"unknown variant {variant!r}; pick from {_variants(1)}")
        cfg.validate_for_parallelism(dist.get_world_size(model))


def make_dist_forward(cfg: FNOConfig, model, *, variant: str = "paper"):
    """The domain-decomposed forward over ``model``:
    ``fwd(local_params, local_x) -> local_y``, every rank of the group(s)
    calling it. ``local_params`` from ``shard_params``; ``local_x`` and
    ``local_y`` laid out by ``input_spec`` (``partition.shard``/``gather``).
    Differentiable; runs where the tensors lie.

    ``model``: one group shards the solution along x (paper Alg. 2); a
    pair (mx_group, my_group) selects the 2-D pencils, x sharded over the
    first and y over the second. None, which ``torch.distributed`` reads
    as every rank, raises.

    variant: "paper" (truncate, then repartition), "eager" (per-dim eager
    truncation) or, 1-D only, "grady31" (the [31] baseline: repartition,
    then truncate).
    """
    _check_dist(cfg, model, variant)

    def forward(local_params: dict, local_x: torch.Tensor) -> torch.Tensor:
        return fno_forward_dist(local_params, local_x, cfg, model, variant)

    return forward


def make_dist_forward_split(cfg: FNOConfig, n_static: int, model, *, variant: str = "paper"):
    """The distributed split forward: ``fwd(local_params, local_pre_static,
    local_x_dyn) -> local_y`` (``fno_forward_split`` on every rank of the
    group(s)). Both inputs take the solution's layout (``input_spec``):
    the channel dim is never sharded. Refuses what ``make_dist_forward``
    refuses."""
    _check_dist(cfg, model, variant)
    block = _dist_block(cfg, model, variant)

    def forward(local_params, local_pre_static, local_x_dyn):
        return _split_forward(local_params, local_pre_static, local_x_dyn, cfg, n_static, block)

    return forward


def make_dist_forward_deep_split(cfg: FNOConfig, n_static: int, model, *,
                                 variant: str = "paper"):
    """The distributed deep split: ``fwd(local_params, local_contrib,
    local_pre_static, local_x_dyn) -> local_y`` (``fno_forward_deep_split``
    on every rank). Each rank rebuilds the full first hidden state and the
    static one on its slab; block 0 runs on the remainder with the rank's
    shard of the cached contribution (laid out by ``contrib_spec``, which
    gives each rank the k_y (x k_z) modes its ``w_spec`` shard makes), the
    other blocks as in ``make_dist_forward``."""
    _check_dist(cfg, model, variant)
    block = _dist_block(cfg, model, variant)

    def forward(local_params, local_contrib, local_pre_static, local_x_dyn):
        return _deep_split_forward(local_params, local_contrib, local_pre_static, local_x_dyn,
                                   cfg, n_static, block)

    return forward


def forward_and_specs(cfg: FNOConfig, model=None, *, variant: str = "paper"):
    """``(forward, x_part, p_parts)``: the one place that decides how an
    FNO batch and its params are laid out, for the trainer.

    ``model`` None, or a model group of one rank (pure data parallelism),
    gives the serial forward with replicated params and the batch split
    over the data group only; a model group or a pencil pair gives
    ``make_dist_forward``'s forward with its layouts. ``forward(params,
    x)`` in every case; ``x_part`` is the batch's ``CartPartition`` and
    ``p_parts`` the params' (``param_partitions``), over the names of
    ``group_names``.
    """
    model = _model_or_serial(model)
    x_part = input_spec("data", model_axes(model))
    if model is None:
        def forward(params, x):
            return fno_forward(params, x, cfg)
    else:
        forward = make_dist_forward(cfg, model, variant=variant)
    return forward, x_part, param_partitions(model)


def _model_or_serial(model):
    """None for no model group or one of a single rank: what runs the
    serial forward on each rank's batch slab."""
    if model is not None and not _is_pair(model) and dist.get_world_size(model) == 1:
        return None
    return model


def split_forward_and_specs(cfg: FNOConfig, n_static: int, model=None, *,
                            variant: str = "paper"):
    """``forward_and_specs`` for the split forward, for a server:
    ``(forward, x_part, p_parts)`` with ``forward(params, pre_static,
    x_dyn)``; both inputs take ``x_part``."""
    model = _model_or_serial(model)
    if model is None:
        def forward(params, pre_static, x_dyn):
            return fno_forward_split(params, pre_static, x_dyn, cfg, n_static)
    else:
        forward = make_dist_forward_split(cfg, n_static, model, variant=variant)
    return forward, input_spec("data", model_axes(model)), param_partitions(model)


def deep_split_forward_and_specs(cfg: FNOConfig, n_static: int, model=None, *,
                                 variant: str = "paper"):
    """``forward_and_specs`` for the deep split: ``(forward, x_part,
    c_part, p_parts)`` with ``forward(params, contrib, pre_static, x_dyn)``;
    ``c_part`` (``contrib_spec``) lays out the contribution."""
    model = _model_or_serial(model)
    if model is None:
        def forward(params, contrib, pre_static, x_dyn):
            return fno_forward_deep_split(params, contrib, pre_static, x_dyn, cfg, n_static)
    else:
        forward = make_dist_forward_deep_split(cfg, n_static, model, variant=variant)
    axes = model_axes(model)
    return (forward, input_spec("data", axes), contrib_spec("data", axes),
            param_partitions(model))
