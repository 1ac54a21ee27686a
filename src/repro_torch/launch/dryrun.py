"""Dry-run of every (arch x shape x mesh) cell: what each rank would hold, on the meta device.

    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --all [--mesh 4x4] [--out-dir artifacts/dryrun_torch]
    python -m repro_torch.launch.dryrun --arch whisper-tiny --shape train_4k --mesh 2x2

The counterpart of ``repro.launch.dryrun``. The reference lowers and
compiles each cell with XLA and reads the compiler's memory and cost
analysis; the port runs eagerly and has no compiler to ask, so this
script builds each cell's trees on the meta device (no memory, no ranks)
and counts, for one rank of a (data x model) mesh:

* the parameters, cut by the port's specs (``transformer.tree_specs``:
  ``param_specs``, whisper's ``whisper_param_specs``; the FNO's
  ``param_partitions``) under the reference's ``_safe`` rule (an axis that
  does not divide a dim is dropped from it), f32 masters for a training
  cell and the serving draw's dtypes (``init_lm_params(serving=True)``)
  for a prefill or decode cell;
* AdamW's moments under ZeRO-1 (``optimizer.zero1_partitions``) and the
  gradient buffer the trainer keeps, for a training cell;
* the decode cache a prefill writes or a decode step reads
  (``transformer.init_cache`` / ``whisper.init_whisper_cache`` under the
  mesh: split caches, the prefix by kv heads or by sequence, whisper's
  caches by the rank's padded heads), bf16; rows whole where the data
  axis does not divide the batch (``_safe``);
* the inputs (``configs.input_specs``; the FNO's solution tensor, and
  its target in training), by the same rule;
* the resident total and whether it fits one card
  (``common.constants.device_memory_bytes``: the card's own capacity when
  one is present);
* ``model_flops`` (a copy of the reference's ``model_flops_lm`` /
  ``model_flops_fno``) and the floor times at the H100's constants: the
  compute floor (the cell's FLOPs over the ranks, at the activation
  dtype's peak) and the HBM floor (every resident byte read once).

Activation memory has no analytic counterpart here (the reference reads
it off the compiled program): every artifact says so, and it is measured
only where ``chip_smoke.py`` runs a layout (``torch.cuda.max_memory_allocated``
beside the dry-run's bytes in its ``dryrun`` phase).

Meshes: the reference's (16 x 16) and (2 x 16 x 16) with its pod axis
folded into data (32 x 16), or ``--mesh DxM``; a pencil FNO config
(``MODEL_AXES`` of two groups) re-carves the mesh's ranks into data x
PENCIL_SHAPE, as the reference does. One JSON a cell goes to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

import torch

from repro_torch.common.constants import (
    HBM_BANDWIDTH, PEAK_FLOPS_BF16, PEAK_FLOPS_F32, device_memory_bytes,
)
from repro_torch.configs import ARCH_IDS, FNO_IDS, get_arch, get_fno
from repro_torch.configs.base import LM_SHAPES, cell_supported, get_shape, input_specs
from repro_torch.models import transformer as tf_lib
from repro_torch.models import whisper as wh_lib
from repro_torch.models.policy import ParallelPolicy

MESHES = {"16x16": (16, 16), "2x16x16": (32, 16)}  # (data, model); the pod axis folded into data
NOT_MEASURED = ("activations: no analytic counterpart in the port (no compiler's memory "
                "analysis); measured only where chip_smoke.py runs a layout")


class _Sized:
    """A stand-in group of ``n`` ranks, rank 0 (every rank's part has one
    shape)."""

    def __init__(self, n: int):
        self.n = n

    def size(self) -> int:
        return self.n

    def rank(self) -> int:
        return 0


def mesh_policy(d: int, p: int) -> ParallelPolicy:
    return ParallelPolicy(mesh={"data": _Sized(d), "model": _Sized(p)})


def parse_mesh(text: str) -> tuple:
    """"DxM" (or a name of ``MESHES``) -> (data, model)."""
    if text in MESHES:
        return MESHES[text]
    d, m = (int(v) for v in text.lower().split("x"))
    return d, m


def _local_numel(shape, dims, sizes: dict) -> int:
    """Elements of one rank's part of a leaf of ``shape`` whose dim i lies
    over the axes ``dims[i]`` (a name, a tuple of names, or None), under
    the reference's ``_safe`` rule: an axis that does not divide its dim is
    dropped."""
    n = 1
    dims = tuple(dims) + (None,) * (len(shape) - len(dims))
    for size, axes in zip(shape, dims):
        names = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
        div = math.prod(sizes.get(a, 1) for a in names)
        n *= size // div if size % div == 0 else size
    return n


def _total(fn, tree, specs) -> int:
    """The sum of ``fn(leaf, spec)`` over a tree beside its spec tree."""
    return sum(n for _, n in tf_lib._leaves(tf_lib._walk(fn, tree, specs)))


def lm_params_meta(cfg, serving: bool) -> dict:
    """``cfg``'s whole parameter tree on the meta device: f32 masters, or
    the serving draw's dtypes."""
    if cfg.family == "encdec":
        return wh_lib.init_whisper_params(cfg, generator=None, device="meta", serving=serving)
    return tf_lib.init_lm_params(cfg, generator=None, device="meta", serving=serving)


def lm_param_bytes(cfg, d: int, p: int, *, serving: bool = False) -> int:
    """Bytes of one rank's parameter shards on a (d x p) mesh."""
    specs = tf_lib.tree_specs(cfg, mesh_policy(d, p))
    sizes = {"data": d, "model": p}
    return _total(lambda t, s: _local_numel(t.shape, s, sizes) * t.element_size(),
                  lm_params_meta(cfg, serving), specs)


def lm_state_bytes(cfg, d: int, p: int) -> dict:
    """A training rank's f32 gradient buffer and AdamW moments (ZeRO-1:
    each moment split over the data axis on its largest still-replicated
    dim that d divides), in bytes."""
    from repro_torch.common.tree import tree_map
    from repro_torch.train.optimizer import zero1_partitions

    pol = mesh_policy(d, p)
    whole = lm_params_meta(cfg, False)
    parts = tf_lib.param_parts(cfg, pol, whole)
    shapes = tree_map(lambda t: tuple(t.shape), whole)
    moments = zero1_partitions(parts, shapes, d)
    sizes = {"data": d, "model": p}
    grads = lm_param_bytes(cfg, d, p)
    mom = _total(lambda t, m: _local_numel(t.shape, m.dims if m else (), sizes) * 4, whole,
                 moments)
    return {"grads": grads, "adamw": 2 * mom}


def lm_cache_bytes(cfg, d: int, p: int, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> int:
    """Bytes of one rank's decode cache of ``batch`` rows and ``max_len``
    positions on a (d x p) mesh, as the port allocates it (its data
    rank's rows, whole where d does not divide them)."""
    pol = mesh_policy(d if batch % d == 0 else 1, p)
    if cfg.family == "encdec":
        cache = wh_lib.init_whisper_cache(cfg, batch, max_len, device="meta", policy=pol,
                                          dtype=dtype)
    else:
        cache = tf_lib.init_cache(cfg, batch, max_len, dtype, device="meta", policy=pol)
    return sum(t.numel() * t.element_size() for _, t in tf_lib._leaves(cache))


def _input_bytes(specs: dict, d: int) -> int:
    return sum(_local_numel(shape, ("data",) if shape else (), {"data": d})
               * torch.empty((), dtype=dt).element_size() for shape, dt in specs.values())


def model_flops_lm(cfg, shape) -> float:
    """The reference's ``model_flops_lm``: 6 N D (train) or 2 N D."""
    n_active = cfg.approx_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def model_flops_fno(cfg, batch: int, kind: str) -> float:
    """The reference's ``model_flops_fno``: spectral einsum + bypass +
    encoder/decoder + FFTs, forward; x3 for training."""
    nx, ny, nz, nt = cfg.grid
    grid_pts = nx * ny * nz * nt
    k_modes = math.prod(cfg.mode_shape)
    w = cfg.width
    spectral = 8.0 * w * w * k_modes          # complex MAC = 8 real flops
    bypass = 2.0 * w * w * grid_pts
    fft = 2 * 5.0 * grid_pts * w * (math.log2(nx) + math.log2(ny) + math.log2(nz) + math.log2(nt))
    per_block = spectral + bypass + fft
    enc = 2.0 * cfg.in_channels * w * grid_pts
    dec = 2.0 * w * cfg.decoder_dim * grid_pts + 2.0 * cfg.decoder_dim * cfg.out_channels * grid_pts
    fwd = batch * (enc + dec + cfg.n_blocks * per_block)
    return 3.0 * fwd if kind == "train" else fwd


def _finish(art: dict, mem: dict, flops: float, n_dev: int, peak: float) -> dict:
    resident = sum(mem.values())
    cap = device_memory_bytes()
    art.update(memory=dict(mem, resident_bytes=resident, device_bytes=cap, fits=resident <= cap,
                           not_counted=NOT_MEASURED),
               model_flops=flops,
               floor_s={"compute": flops / n_dev / peak, "hbm": resident / HBM_BANDWIDTH,
                        "peak_flops": peak, "hbm_bytes_per_s": HBM_BANDWIDTH})
    return art


def lm_cell(arch: str, shape_name: str, d: int, p: int) -> dict:
    """One LM cell's artifact on a (d x p) mesh."""
    cfg, shape = get_arch(arch), get_shape(shape_name)
    train = shape.kind == "train"
    b, s = shape.global_batch, shape.seq_len
    mem = {"params": lm_param_bytes(cfg, d, p, serving=not train)}
    if train:
        mem.update(lm_state_bytes(cfg, d, p))
    else:
        mem["cache"] = lm_cache_bytes(cfg, d, p, b, s)
    mem["inputs"] = _input_bytes(input_specs(cfg, shape), d)
    peak = PEAK_FLOPS_BF16 if cfg.activation_dtype == torch.bfloat16 else PEAK_FLOPS_F32
    art = {"arch": arch, "shape": shape_name, "kind": "lm", "cell_kind": shape.kind,
           "mesh": {"shape": [d, p], "axes": ["data", "model"], "devices": d * p},
           "n_params": int(cfg.approx_params())}
    return _finish(art, mem, model_flops_lm(cfg, shape), d * p, peak)


def _fno_model(sizes: dict):
    """Stand-in model group(s) of ``sizes``: a pencil pair, or one group."""
    if "mx" in sizes:
        return tuple(_Sized(sizes[a]) for a in ("mx", "my"))
    return _Sized(sizes["model"])


def fno_param_bytes(cfg, sizes: dict) -> int:
    """Bytes of one rank's FNO parameters, ``blocks.w_spec`` cut over the
    model axes of ``sizes`` ({"model": P} or {"mx": PX, "my": PY}) by
    ``param_partitions``, the rest whole."""
    from repro_torch.core.fno import param_partitions, param_shapes

    parts, shapes = param_partitions(_fno_model(sizes)), param_shapes(cfg)
    out = 0
    for block, leaves in shapes.items():
        for name, shape in leaves.items():
            part = parts[block][name]
            el = 8 if name == "w_spec" else 4  # complex64, float32
            out += _local_numel(shape, part.dims if part else (), sizes) * el
    return out


def fno_layout(fno_id: str, d: int, p: int) -> tuple:
    """(axis sizes, devices) of an FNO config on a (d x p) mesh: one model
    axis of p, or a pencil config's re-carved (N / (px py)) x px x py."""
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{fno_id.replace('-', '_')}")
    pencil = getattr(mod, "PENCIL_SHAPE", None)
    if getattr(mod, "MODEL_AXES", "model") == "model" or pencil is None:
        return {"data": d, "model": p}, d * p
    px, py = pencil
    if (d * p) % (px * py):
        raise ValueError(f"{fno_id}: pencil {pencil} does not divide {d * p} ranks")
    return {"data": d * p // (px * py), "mx": px, "my": py}, d * p


def fno_cell(fno_id: str, shape_name: str, d: int, p: int) -> dict:
    cfg, shapes = get_fno(fno_id)
    batch, kind = {n: (b, k) for n, b, k in shapes}[shape_name]
    sizes, n_dev = fno_layout(fno_id, d, p)
    params = fno_param_bytes(cfg, sizes)
    mem = {"params": params}
    space = ("data", None, "mx", "my") if "mx" in sizes else ("data", None, "model")
    x = _local_numel((batch, cfg.in_channels) + tuple(cfg.grid), space, sizes) * 4
    y = _local_numel((batch, cfg.out_channels) + tuple(cfg.grid), space, sizes) * 4
    mem["inputs"] = x + (y if kind == "train" else 0)
    if kind == "train":
        from repro_torch.core.fno import param_partitions, param_shapes
        from repro_torch.train.optimizer import zero1_partitions

        moments = zero1_partitions(param_partitions(_fno_model(sizes)), param_shapes(cfg),
                                   sizes["data"])
        mom = 0
        for block, leaves in param_shapes(cfg).items():
            for name, shape in leaves.items():
                m = moments[block][name]
                n = _local_numel(shape, m.dims if m else (), sizes)
                mom += n * (8 + 4 if name == "w_spec" else 8)  # mu complex64 + nu f32; f32 both
        mem.update(grads=params, adamw=mom)
    art = {"arch": fno_id, "shape": shape_name, "kind": "fno", "cell_kind": kind,
           "mesh": {"shape": list(sizes.values()), "axes": list(sizes), "devices": n_dev}}
    return _finish(art, mem, model_flops_fno(cfg, batch, kind), n_dev, PEAK_FLOPS_F32)


def iter_cells():
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        for shape in LM_SHAPES:
            if cell_supported(cfg, shape)[0]:
                yield ("lm", arch, shape.name)
    for fno_id in FNO_IDS:
        for name, _, _ in get_fno(fno_id)[1]:
            yield ("fno", fno_id, name)


def run_cell(kind: str, arch: str, shape: str, mesh: str, out_dir: Optional[str]) -> dict:
    d, p = parse_mesh(mesh)
    art = (fno_cell if kind == "fno" else lm_cell)(arch, shape, d, p)
    art["mesh"]["name"] = mesh
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}_{shape}_{mesh}.json")
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
        art["path"] = path
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", help="architecture id (or FNO id)")
    ap.add_argument("--shape", help="shape name")
    ap.add_argument("--all", action="store_true", help="every supported cell")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--mesh", action="append",
                    help="DxM, or one of 16x16 and 2x16x16 (default: both); repeatable")
    ap.add_argument("--out-dir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    if args.list:
        for kind, arch, shape in iter_cells():
            print(f"{kind:4s} {arch:24s} {shape}")
        return 0
    if args.all:
        cells = list(iter_cells())
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, --all or --list")
        kind = "fno" if args.arch in FNO_IDS else "lm"
        if kind == "lm":
            ok, why = cell_supported(get_arch(args.arch), get_shape(args.shape))
            if not ok:
                print(f"SKIP {args.arch} x {args.shape}: {why}")
                return 0
        cells = [(kind, args.arch, args.shape)]
    fit = total = skipped = 0
    for kind, arch, shape in cells:
        for mesh in args.mesh or list(MESHES):
            try:
                art = run_cell(kind, arch, shape, mesh, args.out_dir)
            except ValueError as e:  # a layout the mesh cannot hold, named by the port
                skipped += 1
                print(f"SKIP {arch} x {shape} [{mesh}]: {e}")
                continue
            m = art["memory"]
            total += 1
            fit += m["fits"]
            print(f"{'OK ' if m['fits'] else 'BIG'} {arch} x {shape} [{mesh}] resident "
                  f"{m['resident_bytes'] / 2**30:.2f} GiB a rank (params "
                  f"{m['params'] / 2**30:.2f}), model_flops {art['model_flops']:.3e}, floors "
                  f"compute {art['floor_s']['compute'] * 1e3:.3f} ms, hbm "
                  f"{art['floor_s']['hbm'] * 1e3:.3f} ms")
    print(f"dryrun: {total} cells, {fit} fit one card of {device_memory_bytes() / 1e9:.1f} GB"
          + (f"; {skipped} skipped" if skipped else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
