"""Checkpoints on the reference's on-disk layout (numpy files, no other deps).

Layout: <dir>/step_<N>/ with
  manifest.json        — leaf names, global shapes/dtypes, shard index
  <leaf>.<shard>.npy   — one file per saved shard + its global slice

The same layout as ``repro.train.checkpoint``, so each side reads what the
other wrote — a whole training state ``{"params", "opt": {"mu", "nu",
"count"}}`` included, so each side resumes the other's run. Leaf names join
the nested dict keys with dots (``params.blocks.w_spec``,
``opt.mu.blocks.w_spec``, ``opt.count``). ``save`` writes each leaf as one
shard; ``restore`` and ``restore_into`` reassemble however many shards a
leaf has, so a checkpoint the JAX trainer wrote model-parallel loads onto
one card. Publication is atomic: written into step_N.tmp, then renamed.
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


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield ".".join(prefix) or "leaf", tree


def _snapshot(leaf) -> np.ndarray:
    """A host copy of a leaf that nothing else shares: on the CPU,
    ``Tensor.numpy()`` shares memory with a tensor that the in-place AdamW
    changes one step later, which an async write would then see."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(
    ckpt_dir: str,
    step: int,
    tree: dict,
    *,
    extra: Optional[dict] = None,
    async_save: bool = False,
    keep: int = 3,
):
    """Save a nested dict of tensors/arrays. Returns ``(final_dir, thread)``:
    the leaves are copied to the host on the caller's thread, and with
    ``async_save`` the files are written on the returned thread (else
    ``thread`` is None)."""
    snapshot = [(name, _snapshot(leaf)) for name, leaf in _flatten(tree)]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")

    def _write():
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, data in snapshot:
            fname = f"{name}.0.npy"
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

    def load(name, shape):
        ent = manifest["leaves"][name]
        arr = np.zeros(ent["shape"], dtype=np.dtype(ent["dtype"]))
        for srec in ent["shards"]:
            sl = tuple(slice(a, b) for a, b in srec["index"])
            arr[sl] = np.load(os.path.join(d, srec["file"]))
        if list(arr.shape) != list(shape):
            raise ValueError(f"{name}: ckpt shape {arr.shape} != expected {tuple(shape)}")
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
        return load(".".join(prefix), node)

    return walk(shapes, ()), step, manifest["extra"]


@torch.no_grad()
def restore_into(ckpt_dir: str, tree: dict, *, step: Optional[int] = None):
    """Load the checkpoint into the tensors of ``tree`` in place (each cast
    to the tensor's dtype and copied to its device), one leaf at a time, so
    restoring a state on the card needs no second copy of it there.
    Returns (step, extra)."""
    step, manifest, load = _open(ckpt_dir, step)
    for name, t in _flatten(tree):
        arr = load(name, t.shape)
        t.copy_(torch.from_numpy(arr))
    return step, manifest["extra"]
