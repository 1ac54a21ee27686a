"""Checkpoints on the reference's on-disk layout (numpy only).

Layout: <dir>/step_<N>/ with
  manifest.json        — leaf names, global shapes/dtypes, shard index
  <leaf>.<shard>.npy   — one file per saved shard + its global slice

The same layout as ``repro.train.checkpoint``, so each side reads what the
other wrote. Leaf names join the nested dict keys with dots
(``params.blocks.w_spec``). ``save`` writes each leaf as one shard;
``restore`` reassembles however many shards a leaf has, so a checkpoint
the JAX trainer wrote model-parallel loads onto one card. Publication is
atomic: written into step_N.tmp, then renamed.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield ".".join(prefix) or "leaf", tree


def _as_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # torch.Tensor
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(
    ckpt_dir: str,
    step: int,
    tree: dict,
    *,
    keep: int = 3,
) -> str:
    """Save a nested dict of arrays/tensors. Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": {}, "leaves": {}}
    for name, leaf in _flatten(tree):
        data = _as_numpy(leaf)
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
    return final


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


def restore(ckpt_dir: str, shapes: dict, *, step: Optional[int] = None):
    """Restore the leaves named by ``shapes`` — a nested dict whose leaves
    are the expected shapes — as numpy arrays in the saved dtypes.

    Leaves the checkpoint holds beyond those (optimizer state) are not
    read. Returns (tree, step, extra).
    """
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

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        return load(".".join(prefix), node)

    return walk(shapes, ()), step, manifest["extra"]
