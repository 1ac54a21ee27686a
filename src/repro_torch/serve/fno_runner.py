"""PDE-scenario ModelRunner: FNO surrogate inference on one device.

Port of ``repro.serve.fno_runner`` for one card. The surrogate is served
through the same slot scheduler as the reference:

  * one scheduler tick = one batched FNO forward over every active slot,
    padded up to the next bucket size. A row's result does not depend on
    what else shares its batch (cuFFT, cuBLAS and the spectral kernel treat
    batch rows independently and deterministically), so a request's
    output is bit-identical however admission interleaves it;
  * the forward is the fused one: every spectral block goes through the
    CUDA kernel on the card (its plain version on the CPU);
  * ingress applies the persisted per-channel normalization, egress
    inverts the target normalization, so callers see physical units;
  * a request may ask for a multi-step autoregressive rollout through
    ``feedback``;
  * with ``n_static > 0`` the first ``n_static`` input channels are the
    static geomodel: its normalized form, encoder prelift and (at the
    ``deep`` level) first-block spectral contribution are cached by
    content hash in a ``GeomodelCache``. Misses are recomputed on the host
    in numpy, deterministically, so cold and warm serving feed the same
    arrays to the same forward and agree bitwise.

Model-parallel meshes, the fleet-shared ``cache_store`` and the gateway's
hooks (``affinity_key``, ``reset``) belong to later slices.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.fno import (
    FNOConfig,
    fno_forward,
    fno_forward_deep_split,
    fno_forward_split,
    param_shapes,
    params_from_numpy,
)
from repro_torch.data.loader import Normalizer
from repro_torch.serve.geomodel_cache import GeomodelCache, GeomodelEntry, content_key
from repro_torch.train import checkpoint as ckpt_lib

FNO_CONFIG_FILE = "fno_config.json"


@dataclasses.dataclass
class ScenarioRequest:
    """One PDE scenario: an input field -> ``steps`` surrogate applications.

    ``x`` is the RAW (physical-units) input ``[c_in, nx, ny, nz, nt]``.
    ``outputs`` collects one de-normalized prediction ``[c_out, nx, ny, nz,
    nt]`` per rollout step. ``priority`` / ``deadline_s`` feed the
    scheduler's admission policy.
    """

    rid: int
    x: np.ndarray
    steps: int = 1
    outputs: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[Exception] = None
    priority: int = 0
    deadline_s: Optional[float] = None

    @property
    def prediction(self) -> np.ndarray:
        """Final rollout step's de-normalized prediction."""
        if not self.outputs:
            if self.error is not None:
                raise RuntimeError(
                    f"request {self.rid} failed before any rollout step "
                    f"completed: {self.error}"
                ) from self.error
            raise RuntimeError(
                f"request {self.rid} has no completed rollout steps yet — "
                f"it was not served (still queued, or run_until_done ran "
                f"out of max_steps; check Scheduler.finished/.failed)"
            )
        return self.outputs[-1]


def default_feedback(
    y: np.ndarray, cfg: FNOConfig, n_channels: Optional[int] = None
) -> np.ndarray:
    """Next rollout input from a raw prediction: hold the final predicted
    frame and repeat it along t, tiling/truncating channels to
    ``n_channels`` (default: ``in_channels``; runners with static geomodel
    channels pass the DYNAMIC channel count)."""
    want = cfg.in_channels if n_channels is None else n_channels
    nt = cfg.grid[3]
    nxt = np.repeat(y[..., -1:], nt, axis=-1)
    if nxt.shape[0] != want:
        reps = -(-want // nxt.shape[0])
        nxt = np.concatenate([nxt] * reps, axis=0)[:want]
    return np.ascontiguousarray(nxt, np.float32)


def _slice_normalizer(norm: Normalizer, sl: slice) -> Normalizer:
    """Per-channel stats restricted to a channel slice (identity passes
    through: its scalar mean/scale broadcast over any channel count)."""
    if norm.identity or norm.mean.ndim == 0:
        return norm
    return Normalizer(norm.mean[:, sl], norm.scale[:, sl])


def _bucket_ladder(max_slots: int, n_dp: int) -> tuple:
    """Padded-bucket sizes: multiples of ``n_dp``, doubling up to max_slots."""
    buckets, b = [], n_dp
    while b < max_slots:
        buckets.append(b)
        b *= 2
    buckets.append(max(n_dp, -(-max_slots // n_dp) * n_dp))
    return tuple(sorted(set(buckets)))


def _np_gelu(x: np.ndarray) -> np.ndarray:
    """The tanh-approximate GELU, in float32 numpy."""
    x = x.astype(np.float32)
    inner = np.float32(0.7978845608028654) * (x + np.float32(0.044715) * x * x * x)
    return np.float32(0.5) * x * (np.float32(1.0) + np.tanh(inner))


class FNORunner:
    """ModelRunner serving batched FNO inference on one device."""

    def __init__(
        self,
        cfg: FNOConfig,
        params: dict,
        *,
        device=None,
        max_slots: int = 4,
        x_normalizer: Optional[Normalizer] = None,
        y_normalizer: Optional[Normalizer] = None,
        feedback: Optional[Callable] = None,
        buckets: Optional[Sequence[int]] = None,
        n_static: int = 0,
        cache="auto",
        cache_bytes: int = 256 << 20,
        cache_level: str = "deep",
    ):
        self.device = resolve_device(device)
        if not 0 <= n_static <= cfg.in_channels:
            raise ValueError(
                f"n_static={n_static} must be in [0, in_channels="
                f"{cfg.in_channels}]"
            )
        if cache_level not in ("prelift", "deep"):
            raise ValueError(
                f"cache_level must be 'prelift' or 'deep', got {cache_level!r}"
            )
        self.cfg = cfg
        self.n_static = int(n_static)
        self._cache_level = cache_level
        # "auto": own cache when there are static channels; None: disabled
        # (same split forward, no reuse); a GeomodelCache may be shared
        self.cache: Optional[GeomodelCache] = (
            GeomodelCache(cache_bytes) if (cache == "auto" and n_static) else
            cache if isinstance(cache, GeomodelCache) else None
        )
        self.buckets = (
            tuple(sorted(set(buckets))) if buckets else _bucket_ladder(max_slots, 1)
        )
        if self.buckets[-1] < max_slots:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_slots {max_slots}:"
                f" every active-set size up to max_slots needs a covering "
                f"bucket (buckets: {self.buckets})"
            )
        self.max_slots = max_slots
        # host copies for the deterministic numpy recompute of cache misses
        self._enc_w = params["encoder"]["w"].detach().cpu().numpy().astype(np.float32)
        self._enc_b = params["encoder"]["b"].detach().cpu().numpy().astype(np.float32)
        self._w0 = None
        if n_static and cache_level == "deep":
            self._w0 = params["blocks"]["w_spec"][0].detach().cpu().numpy().astype(np.complex64)
        self.params = {
            k: {n: t.to(self.device) for n, t in v.items()} for k, v in params.items()
        }
        self.x_normalizer = x_normalizer or Normalizer.from_stats(None)
        self.y_normalizer = y_normalizer or Normalizer.from_stats(None)
        self._x_norm_static = _slice_normalizer(self.x_normalizer, slice(0, n_static))
        self._x_norm_dyn = _slice_normalizer(self.x_normalizer, slice(n_static, None))
        n_dyn = cfg.in_channels - n_static
        self.feedback = feedback or (
            lambda y: default_feedback(y, cfg, n_dyn if n_static else None)
        )
        self._inputs: List[Optional[np.ndarray]] = [None] * max_slots
        self._static_key: List[Optional[str]] = [None] * max_slots
        self._static_raw: List[Optional[np.ndarray]] = [None] * max_slots
        self._dyn: List[Optional[np.ndarray]] = [None] * max_slots
        self._remaining: List[int] = [0] * max_slots
        self.batched_steps = 0  # forward launches (vs scenarios served)

    # -- checkpoint loading --------------------------------------------------
    @classmethod
    def from_checkpoint(
        cls,
        ckpt_dir: str,
        *,
        device=None,
        step: Optional[int] = None,
        max_slots: int = 4,
        feedback: Optional[Callable] = None,
        n_static: int = 0,
        cache="auto",
        cache_bytes: int = 256 << 20,
        cache_level: str = "deep",
    ) -> "FNORunner":
        """Build a runner from a trainer's checkpoint directory.

        Reads the ``fno_config.json`` the trainer writes next to its
        checkpoints (architecture + normalization snapshot) and restores
        the latest (or ``step``) params onto one device, reassembling any
        model-parallel shards. ``use_pallas``, ``comm_chunks`` and
        ``model_shards`` are ignored: the port always serves the fused path
        on one card.
        """
        cfg_path = os.path.join(ckpt_dir, FNO_CONFIG_FILE)
        try:
            with open(cfg_path) as f:
                saved = json.load(f)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"{cfg_path} not found: serve from a checkpoint directory "
                f"written by train.py --mode fno (which persists the FNO "
                f"architecture + normalization snapshot there)"
            ) from None
        cfg = FNOConfig(
            grid=tuple(saved["grid"]),
            modes=tuple(saved["modes"]),
            width=saved["width"],
            in_channels=saved["in_channels"],
            out_channels=saved["out_channels"],
            n_blocks=saved["n_blocks"],
            decoder_dim=saved["decoder_dim"],
        )
        print(
            f"checkpoint recorded model_shards={saved.get('model_shards')}; "
            f"serving on one device"
        )
        dev = resolve_device(device)
        restored, ck_step, _ = ckpt_lib.restore(
            ckpt_dir, {"params": param_shapes(cfg)}, step=step
        )
        kind = saved.get("normalizer", "meanstd")
        ndim = len(cfg.grid) + 2
        normalized = saved.get("normalized", [])
        x_norm = (
            Normalizer.from_stats(saved.get("x_stats"), kind, ndim)
            if "x" in normalized
            else Normalizer.from_stats(None)
        )
        y_norm = (
            Normalizer.from_stats(saved.get("y_stats"), kind, ndim)
            if "y" in normalized
            else Normalizer.from_stats(None)
        )
        runner = cls(
            cfg,
            params_from_numpy(restored["params"], dev),
            device=dev,
            max_slots=max_slots,
            x_normalizer=x_norm,
            y_normalizer=y_norm,
            feedback=feedback,
            n_static=n_static,
            cache=cache,
            cache_bytes=cache_bytes,
            cache_level=cache_level,
        )
        runner.restored_step = ck_step
        return runner

    # -- ModelRunner protocol ------------------------------------------------
    def _check_shape(self, x_raw: np.ndarray) -> np.ndarray:
        expected = (self.cfg.in_channels,) + tuple(self.cfg.grid)
        if tuple(x_raw.shape) != expected:
            raise ValueError(
                f"scenario input shape {tuple(x_raw.shape)} != model's "
                f"{expected}"
            )
        return np.asarray(x_raw, np.float32)

    def _encode(self, x_raw: np.ndarray) -> np.ndarray:
        return self.x_normalizer.encode(self._check_shape(x_raw)[None])[0]

    def _np_spectra(self, prelift: np.ndarray) -> np.ndarray:
        """Truncated kept-mode spectrum of the static first hidden state,
        S(GELU(prelift + b)), computed on the host — the numpy mirror of
        ``core.fno.spectral_prelift``'s first half."""
        h = _np_gelu(prelift + self._enc_b[:, None, None, None, None])
        xf = np.fft.rfft(h, axis=-1)
        xf = np.fft.fftn(xf, axes=(1, 2, 3))
        mx, my, mz, mt = self.cfg.modes
        for ax, m in ((1, mx), (2, my), (3, mz)):
            lo = np.take(xf, range(m), axis=ax)
            hi = np.take(xf, range(xf.shape[ax] - m, xf.shape[ax]), axis=ax)
            xf = np.concatenate([lo, hi], axis=ax)
        xf = xf[..., :mt]
        return np.ascontiguousarray(xf.astype(np.complex64))

    def _np_contribution(self, spectra: np.ndarray) -> np.ndarray:
        """Block 0's static kept-mode contribution W_0 . S(h_static)."""
        return np.ascontiguousarray(
            np.einsum("ixyzt,ioxyzt->oxyzt", spectra, self._w0)
            .astype(np.complex64)
        )

    def _static_entry(self, key: str, x_static_raw: np.ndarray) -> GeomodelEntry:
        """Geomodel intermediates by content: local cache, then a host
        recompute of whatever levels are missing (each level derives from
        the previous). The recompute is deterministic numpy, so cold ==
        warm bitwise."""
        deep = self._cache_level == "deep"
        entry = self.cache.get(key) if self.cache is not None else None
        fresh = entry is None
        if fresh:
            normalized = self._x_norm_static.encode(
                np.asarray(x_static_raw, np.float32)[None]
            )[0]
            prelift = np.einsum(
                "ixyzt,io->oxyzt", normalized, self._enc_w[: self.n_static]
            ).astype(np.float32)
            entry = GeomodelEntry(key, normalized, prelift)
        grew = False
        if deep and entry.contribution is None:
            if entry.spectra is None:
                entry = dataclasses.replace(
                    entry, spectra=self._np_spectra(entry.prelift)
                )
            entry = dataclasses.replace(
                entry, contribution=self._np_contribution(entry.spectra)
            )
            grew = True
        if self.cache is not None and (fresh or grew):
            self.cache.put(key, entry)
        return entry

    def request_key(self, req: ScenarioRequest):
        """Content key for scheduler dedup: identical input + identical
        rollout length means byte-identical work."""
        return (content_key(np.asarray(req.x, np.float32)), int(req.steps))

    def fanout(self, primary: ScenarioRequest, follower: ScenarioRequest) -> None:
        """Give a deduped follower the primary's outputs (shared arrays —
        served outputs are treated as read-only)."""
        follower.outputs = list(primary.outputs)

    def admit(self, slot: int, req: ScenarioRequest) -> None:
        if req.steps < 1:
            raise ValueError(f"request {req.rid}: steps must be >= 1")
        if self.n_static:
            x = self._check_shape(req.x)
            static_raw = np.ascontiguousarray(x[: self.n_static])
            self._static_key[slot] = content_key(static_raw)
            self._static_raw[slot] = static_raw
            self._dyn[slot] = self._x_norm_dyn.encode(x[self.n_static:][None])[0]
        else:
            self._inputs[slot] = self._encode(req.x)
        self._remaining[slot] = int(req.steps)

    def _zeros_batch(self, bucket: int):
        grid = tuple(self.cfg.grid)
        if not self.n_static:
            return (np.zeros((bucket, self.cfg.in_channels) + grid, np.float32),)
        pre = np.zeros((bucket, self.cfg.width) + grid, np.float32)
        xd = np.zeros((bucket, self.cfg.in_channels - self.n_static) + grid, np.float32)
        if self._cache_level == "deep":
            ck = np.zeros((bucket, self.cfg.width) + self.cfg.mode_shape, np.complex64)
            return ck, pre, xd
        return pre, xd

    def _batch_forward(self, *arrays) -> np.ndarray:
        """One batched forward on host arrays: the plain, split or
        deep-split forward, matching the runner's cache level."""
        cfg, n = self.cfg, self.n_static
        if not n:
            fn = lambda p, x: fno_forward(p, x, cfg)  # noqa: E731
        elif self._cache_level == "deep":
            fn = lambda p, c, pr, x: fno_forward_deep_split(p, c, pr, x, cfg, n)  # noqa: E731
        else:
            fn = lambda p, pr, x: fno_forward_split(p, pr, x, cfg, n)  # noqa: E731
        with torch.inference_mode():
            y = fn(self.params, *(torch.from_numpy(a).to(self.device) for a in arrays))
            return y.cpu().numpy()

    def warmup(self) -> float:
        """Run every bucket shape once on zeros (kernel build, FFT plans);
        returns seconds spent, so callers can report it apart from
        steady-state serving."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self._batch_forward(*self._zeros_batch(b))
        return time.perf_counter() - t0

    def bucket_for(self, n_active: int) -> int:
        for b in self.buckets:
            if b >= n_active:
                return b
        raise ValueError(
            f"{n_active} active slots exceed the largest bucket "
            f"{self.buckets[-1]}"
        )

    def step(self, slots: Sequence[Optional[ScenarioRequest]], active: Sequence[int]) -> list:
        batch = self._zeros_batch(self.bucket_for(len(active)))
        grid = tuple(self.cfg.grid)
        for j, i in enumerate(active):
            if not self.n_static:
                batch[0][j] = self._inputs[i]
                continue
            entry = self._static_entry(self._static_key[i], self._static_raw[i])
            batch[-2][j] = entry.prelift
            batch[-1][j] = self._dyn[i]
            if self._cache_level == "deep":
                batch[0][j] = entry.contribution
        yb = self._batch_forward(*batch)
        del batch
        self.batched_steps += 1
        finished = []
        n_dyn = self.cfg.in_channels - self.n_static
        for j, i in enumerate(active):
            req = slots[i]
            y_raw = self.y_normalizer.decode(yb[j : j + 1])[0]
            req.outputs.append(y_raw)
            self._remaining[i] -= 1
            if self._remaining[i] > 0:
                fb = np.asarray(self.feedback(y_raw), np.float32)
                if self.n_static:
                    if tuple(fb.shape) != (n_dyn,) + grid:
                        raise ValueError(
                            f"feedback returned shape {tuple(fb.shape)}; "
                            f"with n_static={self.n_static} it must return "
                            f"the dynamic channels {(n_dyn,) + grid}"
                        )
                    self._dyn[i] = self._x_norm_dyn.encode(fb[None])[0]
                else:
                    self._inputs[i] = self._encode(fb)
            else:
                finished.append(i)
        return finished

    def retire(self, slot: int, req: ScenarioRequest) -> None:
        self._inputs[slot] = None
        self._static_key[slot] = None
        self._static_raw[slot] = None
        self._dyn[slot] = None
        self._remaining[slot] = 0
