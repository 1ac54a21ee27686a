"""Checkpoints on the reference's on-disk layout (numpy files, no other deps).

Layout: <dir>/step_<N>/ with
  manifest.json        — leaf names, global shapes/dtypes, shard index
  <leaf>.<shard>.npy   — one file per saved shard + its global slice

The same layout as ``repro.train.checkpoint``, so each side reads what the
other wrote — a whole training state ``{"params", "opt": {"mu", "nu",
"count"}}`` included, so each side resumes the other's run. Leaf names join
the nested dict keys with dots (``params.blocks.w_spec``,
``opt.mu.blocks.w_spec``, ``opt.count``; an LM's ``params.tail.0.ln1``,
list entries by index, no file for a None such as ``layer0``). ``save``
writes each leaf as one shard; ``restore`` and ``restore_into`` reassemble
however many shards a leaf has, so a checkpoint the JAX trainer wrote
model-parallel loads onto one card. Publication is atomic: written into
step_N.tmp, then renamed.

Across ranks (``parts``, a tree of ``CartPartition`` over the state, and
``groups``), ``save`` gathers every sharded leaf to its global tensor, with
every rank joining each gather, and rank 0 alone writes the serial
format, a block at a time; ``restore_into`` reads from each global leaf
only this rank's shard. So a checkpoint resumes on any layout, and the
serial trainer, the JAX trainer and both serving runners read it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.partition import CartPartition, gather


def _flatten(tree, prefix=()):
    """(name, leaf) of every leaf, named as the reference names them: dict
    keys and list indices joined with dots, None an empty subtree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif tree is not None:
        yield ".".join(prefix) or "leaf", tree


def _snapshot(leaf) -> np.ndarray:
    """A host copy of a leaf that nothing else shares: on the CPU,
    ``Tensor.numpy()`` shares memory with a tensor that the in-place AdamW
    changes one step later, which an async write would then see."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _pieces(leaf, part: CartPartition, groups):
    """The global value of a sharded leaf as ``(index, host array)`` pieces
    on rank 0: ``(None, the whole)``, or one piece per index of dim 0 when
    only later dims are sharded, so the card and the host hold one block
    of it at a time. Every rank of the partition's groups runs it; the
    other ranks get ``(index, None)``."""
    rank0 = dist.get_rank() == 0
    if part.dims[0] is not None or leaf.ndim < 2:
        full = gather(leaf.detach(), part, groups)
        yield None, _snapshot(full) if rank0 else None
    else:
        inner = CartPartition(part.dims[1:])
        for i in range(leaf.shape[0]):
            full = gather(leaf[i].detach(), inner, groups)
            yield i, _snapshot(full) if rank0 else None


def _gathered_into(tmp: str, tree: dict, parts: dict, groups) -> Optional[list]:
    """Gather every leaf of a sharded ``tree`` to its global value; rank 0
    writes each sharded leaf piece by piece into its file in ``tmp`` (a
    memory map, so its host holds one block at a time) and keeps the
    replicated ones. Returns rank 0's ``[(name, array or map)]``, None on
    the other ranks."""
    rank0 = dist.get_rank() == 0
    if rank0:
        _fresh(tmp)
    part_of = dict(_flatten(parts))
    out = []
    for name, leaf in _flatten(tree):
        part = part_of.get(name)
        if part is None or not part.sharded_dims():
            out.append((name, _snapshot(leaf) if rank0 else None))
            continue
        shape = part.global_shape(leaf.shape, groups)
        data = None
        for i, piece in _pieces(leaf, part, groups):
            if rank0:
                if data is None:
                    data = np.lib.format.open_memmap(os.path.join(tmp, f"{name}.0.npy"), mode="w+",
                                                     dtype=piece.dtype, shape=shape)
                data[() if i is None else i] = piece
        out.append((name, data))
    return out if rank0 else None


def _fresh(path: str) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)


def save(
    ckpt_dir: str,
    step: int,
    tree: dict,
    *,
    extra: Optional[dict] = None,
    async_save: bool = False,
    keep: int = 3,
    parts: Optional[dict] = None,
    groups=None,
):
    """Save a nested dict of tensors/arrays. Returns ``(final_dir, thread)``:
    the leaves are copied to the host on the caller's thread, and with
    ``async_save`` the files are written on the returned thread (else
    ``thread`` is None).

    With ``parts`` (the partition of every leaf, None for replicated) every
    rank calls it with its local leaves: each sharded leaf is gathered to
    its global value, which rank 0 writes into its file as it comes (the
    thread then flushes the files and publishes the step); on the other
    ranks nothing is written and ``thread`` is None.
    """
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if parts is None:
        snapshot = [(name, _snapshot(leaf)) for name, leaf in _flatten(tree)]
    else:
        snapshot = _gathered_into(tmp, tree, parts, groups)
        if snapshot is None:
            return final, None

    def _write():
        if parts is None:
            _fresh(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, data in snapshot:
            fname = f"{name}.0.npy"
            if isinstance(data, np.memmap):
                data.flush()
            else:
                np.save(os.path.join(tmp, fname), data)
            manifest["leaves"][name] = {
                "shape": list(data.shape),
                "dtype": str(data.dtype),
                "shards": [{"file": fname, "index": [[0, d] for d in data.shape]}],
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _cleanup(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return final, t
    _write()
    return final, None


def _cleanup(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _open(ckpt_dir: str, step: Optional[int]):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(name, shape, region=None):
        """The leaf of global ``shape``, or only its ``region`` (a tuple of
        slices): each shard file is mapped, and only its overlap with the
        region is read."""
        ent = manifest["leaves"][name]
        if list(ent["shape"]) != list(shape):
            raise ValueError(f"{name}: ckpt shape {tuple(ent['shape'])} != expected {tuple(shape)}")
        region = region or tuple(slice(0, n) for n in shape)
        arr = np.zeros([r.stop - r.start for r in region], dtype=np.dtype(ent["dtype"]))
        for srec in ent["shards"]:
            lo = [max(a, r.start) for (a, _), r in zip(srec["index"], region)]
            hi = [min(b, r.stop) for (_, b), r in zip(srec["index"], region)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - s[0], b - s[0]) for a, b, s in zip(lo, hi, srec["index"]))
            dst = tuple(slice(a - r.start, b - r.start) for a, b, r in zip(lo, hi, region))
            arr[dst] = np.load(os.path.join(d, srec["file"]), mmap_mode="r")[src]
        return arr

    return step, manifest, load


def restore(ckpt_dir: str, shapes: dict, *, step: Optional[int] = None):
    """Restore the leaves named by ``shapes`` — a nested dict whose leaves
    are the expected shapes — as numpy arrays in the saved dtypes.

    Leaves the checkpoint holds beyond those (optimizer state) are not
    read. Returns (tree, step, extra).
    """
    step, manifest, load = _open(ckpt_dir, step)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, prefix + (str(i),)) for i, v in enumerate(node)]
        return None if node is None else load(".".join(prefix), node)

    return walk(shapes, ()), step, manifest["extra"]


@torch.no_grad()
def restore_into(ckpt_dir: str, tree: dict, *, step: Optional[int] = None,
                 parts: Optional[dict] = None, groups=None):
    """Load the checkpoint into the tensors of ``tree`` in place (each cast
    to the tensor's dtype and copied to its device), one leaf at a time, so
    restoring a state on the card needs no second copy of it there.

    With ``parts`` the tensors are this rank's shards: each reads only
    the region of its global leaf that its partition gives this rank, so a
    checkpoint saved on one layout resumes on another (no collective) and
    the host holds no global leaf. Returns (step, extra)."""
    step, manifest, load = _open(ckpt_dir, step)
    part_of = dict(_flatten(parts)) if parts is not None else {}
    for name, t in _flatten(tree):
        part = part_of.get(name)
        if part is None:
            t.copy_(torch.from_numpy(load(name, t.shape)))
        else:
            shape = part.global_shape(t.shape, groups)
            t.copy_(torch.from_numpy(load(name, shape, part.index(shape, groups))))
    return step, manifest["extra"]
