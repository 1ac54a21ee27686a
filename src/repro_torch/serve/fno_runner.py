"""PDE-scenario ModelRunner: FNO surrogate inference on one device or
model-parallel over ranks.

Port of ``repro.serve.fno_runner``. The surrogate is served through the
same slot scheduler as the reference:

  * one scheduler tick = one batched FNO forward over every active slot,
    padded up to the next bucket size. A row's result does not depend on
    what else shares its batch (cuFFT, cuBLAS and the spectral kernel treat
    batch rows independently and deterministically), so a request's
    output is bit-identical however admission interleaves it;
  * the forward is the fused one: every spectral block goes through the
    CUDA kernel on the card (its plain version on the CPU);
  * given the groups of ``launch.mesh.build_fno_groups`` the runner serves
    over a (data x model) layout of ranks, 1-D or 2-D pencils, each rank
    holding its shard of the spectral weights. Rank 0 is the controller:
    it alone holds the requests, the scheduler, the normalizers and the
    geomodel cache. Each tick it broadcasts a header (which forward, the
    bucket, or stop), scatters every rank's slab of the host batch by the
    forward's partitions, runs its own share of the forward and gathers
    the output slabs back; the other ranks run ``follow`` until the
    controller's ``close``. So no rank can run a different tick, and cold
    and warm serving scatter the same host arrays and agree bitwise. The
    slabs travel through the host (``gloo``, CPU tensors);
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

On a local miss the controller consults the fleet-shared ``cache_store``
(``serve.cache_store``), namespaced by ``cache_version``, before it
recomputes: a geomodel warmed by any replica is warm fleet-wide, and a
store hit gives bitwise the arrays a recompute gives. The gateway's hooks
are ``affinity_key`` (the geomodel's content key, for cache-affine
routing) and ``reset`` (a failed-over request restarts). R ranked runners
built alike on every rank serve as R gateway replicas over one start of
the ranks once ``link_replicas`` has linked them: the header also names
the replica, and a follower's one loop runs each tick on the replica it
names.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
import weakref
from typing import Callable, Deque, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.core.fno import (
    FNOConfig,
    deep_split_forward_and_specs,
    forward_and_specs,
    group_names,
    param_shapes,
    split_forward_and_specs,
)
from repro_torch.core.partition import CartPartition, coords
from repro_torch.data.loader import Normalizer
from repro_torch.serve.cache_store import CacheStore
from repro_torch.serve.geomodel_cache import GeomodelCache, GeomodelEntry, content_key
from repro_torch.train import checkpoint as ckpt_lib

FNO_CONFIG_FILE = "fno_config.json"

# The forward a tick runs, as the controller's header names it (0: stop);
# the header is [kind, bucket, replica].
_STOP, _PLAIN, _SPLIT, _DEEP = range(4)
# How many ticks' times a runner keeps (``FNORunner.tick_times``).
TICK_TIMES_KEPT = 1024


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


def load_serving_config(ckpt_dir: str, comm_chunks: Optional[int] = None) -> tuple:
    """(cfg, saved): the ``FNOConfig`` and the whole ``fno_config.json``
    a trainer wrote beside its checkpoints. ``comm_chunks`` defaults to
    what training recorded."""
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
        comm_chunks=int(saved.get("comm_chunks", 1) if comm_chunks is None else comm_chunks),
    )
    return cfg, saved


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


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _np_gelu(x: np.ndarray) -> np.ndarray:
    """The tanh-approximate GELU, in float32 numpy:
    0.5 x (1 + tanh(0.79788456 (x + 0.044715 x^3))), evaluated in place
    in that order (one temporary beside the copy of ``x``)."""
    x = x.astype(np.float32)
    t = np.float32(0.044715) * x
    t *= x
    t *= x
    t += x
    t *= np.float32(0.7978845608028654)
    np.tanh(t, out=t)
    t += np.float32(1.0)
    x *= np.float32(0.5)
    x *= t
    return x


class FNORunner:
    """ModelRunner serving batched FNO inference on one device, or over a
    (data x model) layout of ranks.

    ``data_group`` and ``model`` are what ``build_fno_groups`` returns (the
    model group, or the (mx, my) pencil pair); every rank of the world
    constructs the runner with the same arguments and its own shard of the
    parameters (``shard_params``, or ``from_checkpoint``). Rank 0 then
    serves through the scheduler and ends with ``close``; the others call
    ``follow``. Without groups the runner serves on ``device`` alone.
    ``link_replicas`` lets several ranked runners share the ranks.
    """

    def __init__(
        self,
        cfg: FNOConfig,
        params: dict,
        *,
        device=None,
        data_group=None,
        model=None,
        max_slots: int = 4,
        x_normalizer: Optional[Normalizer] = None,
        y_normalizer: Optional[Normalizer] = None,
        feedback: Optional[Callable] = None,
        buckets: Optional[Sequence[int]] = None,
        n_static: int = 0,
        cache="auto",
        cache_bytes: int = 256 << 20,
        cache_level: str = "deep",
        cache_store: Optional[CacheStore] = None,
    ):
        self.device = resolve_device(device)
        if (data_group is None) != (model is None):
            raise ValueError("pass both the data group and the model group(s) "
                             "build_fno_groups returns, or neither")
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
        self._ranked = data_group is not None
        self.rank = dist.get_rank() if self._ranked else 0
        self.is_controller = self.rank == 0
        # "auto": own cache when there are static channels; None: disabled
        # (same split forward, no reuse); a GeomodelCache may be shared.
        # Only the controller stages batches, so only it holds one.
        self.cache: Optional[GeomodelCache] = (
            GeomodelCache(cache_bytes) if (cache == "auto" and n_static) else
            cache if isinstance(cache, GeomodelCache) else None
        ) if self.is_controller else None
        # the fleet-shared tier consulted on a local miss (the controller's)
        self.cache_store = cache_store if self.is_controller else None
        n_dp = dist.get_world_size(data_group) if self._ranked else 1
        self.buckets = (
            tuple(sorted(set(buckets))) if buckets else _bucket_ladder(max_slots, n_dp)
        )
        for b in self.buckets:
            if b % n_dp:
                raise ValueError(
                    f"bucket {b} not divisible by data-parallel size "
                    f"{n_dp} (buckets: {self.buckets})"
                )
        if self.buckets[-1] < max_slots:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_slots {max_slots}:"
                f" every active-set size up to max_slots needs a covering "
                f"bucket (buckets: {self.buckets})"
            )
        self.max_slots = max_slots
        self._kind = _PLAIN if not n_static else _DEEP if cache_level == "deep" else _SPLIT
        self._groups = group_names(data_group, model) if self._ranked else None
        self._forward, parts = self._layout(model)
        if self._ranked:
            want = self._local_param_shapes(cfg, data_group, model)["blocks"]["w_spec"]
            got = tuple(params["blocks"]["w_spec"].shape)
            if got != want:
                raise ValueError(f"w_spec {got} is not this rank's shard {want}: pass "
                                 f"shard_params(params, model)")
        # host copies for the deterministic numpy recompute of cache misses
        self._enc_w = params["encoder"]["w"].detach().cpu().numpy().astype(np.float32)
        self._enc_b = params["encoder"]["b"].detach().cpu().numpy().astype(np.float32)
        # every rank's (rank, size) in each group: the controller slices
        # each rank's slab of a host batch from them
        self._coords = None
        if self._ranked:
            self._coords = [None] * dist.get_world_size()
            dist.all_gather_object(self._coords, coords(self._groups))
        # deep level: the controller's host copy of block 0's spectral
        # weights, whole (each rank holds only its shard: gathered to the
        # controller's host)
        self._w0 = None
        if self._kind == _DEEP:
            w0 = params["blocks"]["w_spec"][0].detach().cpu()
            w_part = parts["blocks"]["w_spec"]
            w0 = w0.numpy() if w_part is None else self._to_controller(
                w0, CartPartition(w_part.dims[1:]), param_shapes(cfg)["blocks"]["w_spec"][1:])
            if self.is_controller:
                self._w0 = w0.astype(np.complex64)
            del w0
        self.params = {
            k: {n: t.to(self.device) for n, t in v.items()} for k, v in params.items()
        }
        self._closed = False
        # this runner's index among the replicas that share its ranks, and
        # weak references to those replicas (``link_replicas``; None: this
        # runner alone), so that no runner keeps another, or itself, alive
        self.replica = 0
        self._fleet = None
        self._cache_version = None
        # the last ticks' seconds staging the host batch (controller; a
        # cold deep tick's spectral prefix included), scattering it, in the
        # forward and gathering the output
        self.tick_times: Deque[dict] = collections.deque(maxlen=TICK_TIMES_KEPT)
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

    def _layout(self, model):
        """(forward, parameter partitions) of this runner's kind over
        ``model``, and each forward operand's (partition, per-row shape,
        dtype) in ``self._operands``."""
        cfg, n = self.cfg, self.n_static
        model = model if self._ranked else None
        grid = tuple(cfg.grid)
        rows = [(cfg.width,) + grid, (cfg.in_channels - n,) + grid]
        if self._kind == _PLAIN:
            fwd, x_part, p_parts = forward_and_specs(cfg, model)
            self._operands = [(x_part, (cfg.in_channels,) + grid, torch.float32)]
        elif self._kind == _SPLIT:
            fwd, x_part, p_parts = split_forward_and_specs(cfg, n, model)
            self._operands = [(x_part, r, torch.float32) for r in rows]
        else:
            fwd, x_part, c_part, p_parts = deep_split_forward_and_specs(cfg, n, model)
            self._operands = [(c_part, (cfg.width,) + cfg.mode_shape, torch.complex64)] + [
                (x_part, r, torch.float32) for r in rows]
        self._x_part = x_part
        return fwd, p_parts

    @staticmethod
    def _local_param_shapes(cfg: FNOConfig, data_group, model) -> dict:
        """Each parameter leaf's shape on this rank under the groups (its
        shard of ``w_spec``; every other leaf whole)."""
        _, _, p_parts = forward_and_specs(cfg, model)
        groups = group_names(data_group, model)
        return {g: {n: s if p_parts[g][n] is None else p_parts[g][n].local_shape(s, groups)
                    for n, s in leaves.items()}
                for g, leaves in param_shapes(cfg).items()}

    # -- checkpoint loading --------------------------------------------------
    @classmethod
    def from_checkpoint(
        cls,
        ckpt_dir: str,
        *,
        device=None,
        data_group=None,
        model=None,
        step: Optional[int] = None,
        max_slots: int = 4,
        feedback: Optional[Callable] = None,
        n_static: int = 0,
        cache="auto",
        cache_bytes: int = 256 << 20,
        cache_level: str = "deep",
        cache_store: Optional[CacheStore] = None,
        comm_chunks: Optional[int] = None,
    ) -> "FNORunner":
        """Build a runner from a trainer's checkpoint directory.

        Reads the ``fno_config.json`` the trainer writes next to its
        checkpoints (architecture + normalization snapshot) and restores
        the latest (or ``step``) params: onto one device, or, given the
        groups of ``build_fno_groups``, each rank only its region of every
        sharded leaf (``checkpoint.restore_into``), whatever layout wrote
        the checkpoint. ``comm_chunks`` defaults to what training recorded.
        ``use_pallas`` is ignored: the port always serves the fused path.
        """
        cfg, saved = load_serving_config(ckpt_dir, comm_chunks)
        dev = resolve_device(device)
        ranked = data_group is not None
        if not ranked or dist.get_rank() == 0:
            where = "one device" if not ranked else (
                f"{dist.get_world_size(data_group)} data x "
                + "x".join(str(dist.get_world_size(g)) for g in
                           (model if isinstance(model, (tuple, list)) else (model,)))
                + " model ranks")
            print(f"checkpoint recorded model_shards={saved.get('model_shards')}; "
                  f"serving on {where}")
        shapes = (cls._local_param_shapes(cfg, data_group, model) if ranked
                  else param_shapes(cfg))
        params = {g: {n: torch.empty(s, device=dev, dtype=torch.complex64 if n == "w_spec"
                                     else torch.float32) for n, s in leaves.items()}
                  for g, leaves in shapes.items()}
        parts = groups = None
        if ranked:
            parts = {"params": forward_and_specs(cfg, model)[2]}
            groups = group_names(data_group, model)
        ck_step, _ = ckpt_lib.restore_into(ckpt_dir, {"params": params}, step=step,
                                           parts=parts, groups=groups)
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
            params,
            device=dev,
            data_group=data_group,
            model=model,
            max_slots=max_slots,
            x_normalizer=x_norm,
            y_normalizer=y_norm,
            feedback=feedback,
            n_static=n_static,
            cache=cache,
            cache_bytes=cache_bytes,
            cache_level=cache_level,
            cache_store=cache_store,
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

    @property
    def cache_version(self) -> str:
        """Checkpoint+config signature namespacing fleet-shared store
        entries (the controller's): the grid, modes, width, input channels,
        static channels and cache level, the encoder weights, the static
        normalizer's stats and block 0's whole kept-mode weights, so
        replicas serving another checkpoint or configuration never
        exchange intermediates."""
        if self._cache_version is None:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            h.update(repr((
                tuple(self.cfg.grid), tuple(self.cfg.modes), self.cfg.width,
                self.cfg.in_channels, self.n_static, self._cache_level,
            )).encode())
            parts = [self._enc_w, self._enc_b]
            norm = self._x_norm_static
            if not norm.identity:
                parts += [norm.mean, norm.scale]
            if self._w0 is not None:
                parts.append(self._w0)
            for a in parts:
                arr = np.ascontiguousarray(np.asarray(a))
                h.update(str(arr.dtype).encode())
                h.update(str(arr.shape).encode())
                h.update(arr)
            self._cache_version = h.hexdigest()
        return self._cache_version

    def _np_spectra(self, prelift: np.ndarray) -> np.ndarray:
        """Truncated kept-mode spectrum of the static first hidden state,
        S(GELU(prelift + b)), computed on the host — the numpy mirror of
        ``core.fno.spectral_prelift``'s first half. Each dim is truncated
        right after its transform (t first), as the eager schedule does:
        the same spectrum, with the x, y and z transforms on the kept t
        bins only."""
        h = _np_gelu(prelift + self._enc_b[:, None, None, None, None])
        mx, my, mz, mt = self.cfg.modes
        xf = np.fft.rfft(h, axis=-1)[..., :mt]
        del h
        for ax, m in ((1, mx), (2, my), (3, mz)):
            xf = np.fft.fft(xf, axis=ax)
            n = xf.shape[ax]
            xf = np.take(xf, np.r_[0:m, n - m:n], axis=ax)
        return np.ascontiguousarray(xf.astype(np.complex64))

    def _np_contribution(self, spectra: np.ndarray) -> np.ndarray:
        """Block 0's static kept-mode contribution W_0 . S(h_static)."""
        return np.ascontiguousarray(
            np.einsum("ixyzt,ioxyzt->oxyzt", spectra, self._w0)
            .astype(np.complex64)
        )

    def _static_entry(self, key: str, x_static_raw: np.ndarray) -> GeomodelEntry:
        """Geomodel intermediates by content: local cache, then the
        fleet-shared store, then a host recompute of whatever levels are
        missing (each level derives from the previous). Fresh or deepened
        entries go to both tiers, a store hit into the local cache. The
        recompute is deterministic numpy, so cold == warm == a store hit,
        bitwise."""
        deep = self._cache_level == "deep"
        entry = self.cache.get(key) if self.cache is not None else None
        from_store = False
        if entry is None and self.cache_store is not None:
            entry = self.cache_store.get(self.cache_version, key)
            from_store = entry is not None
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
        if self.cache is not None and (fresh or grew or from_store):
            self.cache.put(key, entry)
        if self.cache_store is not None and (fresh or grew):
            self.cache_store.put(self.cache_version, key, entry)
        return entry

    def request_key(self, req: ScenarioRequest):
        """Content key for scheduler dedup: identical input + identical
        rollout length means byte-identical work."""
        return (content_key(np.asarray(req.x, np.float32)), int(req.steps))

    def fanout(self, primary: ScenarioRequest, follower: ScenarioRequest) -> None:
        """Give a deduped follower the primary's outputs (shared arrays —
        served outputs are treated as read-only)."""
        follower.outputs = list(primary.outputs)

    def affinity_key(self, req: ScenarioRequest) -> Optional[str]:
        """The gateway's cache-affinity key: the content key of the static
        channels (the geomodel), so that one replica serves each geomodel
        and its cache hits as a lone runner's would; None without static
        channels or for an input ``admit`` would refuse."""
        if not self.n_static:
            return None
        x = np.asarray(req.x, np.float32)
        if x.ndim != len(self.cfg.grid) + 1 or x.shape[0] < self.n_static:
            return None
        return content_key(np.ascontiguousarray(x[: self.n_static]))

    def reset(self, req: ScenarioRequest) -> None:
        """The gateway's failover hook: a request taken off a failed
        replica restarts from its ``x``, its partial outputs dropped."""
        req.outputs = []
        req.done = False
        req.error = None

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
        """The forward's host operands for ``bucket`` rows, zeroed: (x,),
        (pre_static, x_dyn) or (contrib, pre_static, x_dyn)."""
        return tuple(np.zeros((bucket,) + row, np.complex64 if dt == torch.complex64
                              else np.float32) for _, row, dt in self._operands)

    def _batch_forward(self, *arrays) -> np.ndarray:
        """One batched forward on host arrays (the plain, split or
        deep-split forward, matching the runner's cache level): on the
        runner's device, or as the controller of a tick on every rank."""
        if not self.is_controller:
            raise RuntimeError(f"rank {self.rank} follows rank 0's ticks: call follow()")
        if self._closed:
            raise RuntimeError("the runner's followers were stopped (close()): no tick can run")
        bucket = arrays[0].shape[0]
        if self._ranked:
            self._header(self._kind, bucket)
        return self._tick(bucket, arrays)

    def _header(self, kind: int = _STOP, bucket: int = 0) -> tuple:
        """The controller's (kind, bucket, replica), broadcast to every rank."""
        h = torch.tensor([kind, bucket, self.replica], dtype=torch.int64)
        dist.broadcast(h, src=0)
        return int(h[0]), int(h[1]), int(h[2])

    def _tick(self, bucket: int, arrays) -> Optional[np.ndarray]:
        """One forward over ``bucket`` rows on this rank: its slab of each
        host operand in (scattered by the controller, which alone passes
        ``arrays``), the output slabs out (gathered to the controller)."""
        times = {}
        t = time.perf_counter()
        if self._ranked:
            local = [self._scatter(part, (bucket,) + row, dt, a)
                     for (part, row, dt), a in zip(self._operands, arrays or [None] * 3)]
        else:
            local = [torch.from_numpy(a).to(self.device) for a in arrays]
        times["scatter"], t = self._lap(t)
        with torch.inference_mode():
            y = self._forward(self.params, *local)
            del local
            times["forward"], t = self._lap(t)
            y = y.cpu()
        out = (self._to_controller(y, self._x_part, (bucket, self.cfg.out_channels)
                                   + tuple(self.cfg.grid)) if self._ranked else y.numpy())
        times["gather"], _ = self._lap(t)
        self.tick_times.append(times)
        return out

    def _lap(self, t0: float) -> tuple:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        return t - t0, t

    def _scatter(self, part: CartPartition, shape: tuple, dtype, array) -> torch.Tensor:
        """This rank's slab of the controller's host ``array`` of global
        ``shape``, on the runner's device. Complex slabs travel as their
        real view."""
        local = torch.empty(part.local_shape(shape, self._groups), dtype=dtype)
        slabs = None
        if self.is_controller:
            slabs = [_real(torch.from_numpy(np.ascontiguousarray(array[part.index_at(shape, at)])))
                     for at in self._coords]
        dist.scatter(_real(local), slabs, src=0)
        return local.to(self.device)

    def _to_controller(self, local: torch.Tensor, part: CartPartition,
                       shape: tuple) -> Optional[np.ndarray]:
        """The global array of ``shape`` on the controller from every rank's
        slab ``local`` (a CPU tensor laid out by ``part``); None elsewhere.
        Complex slabs travel as their real view."""
        local = local.contiguous()
        slabs = [torch.empty_like(local) for _ in self._coords] if self.is_controller else None
        dist.gather(_real(local), slabs and [_real(t) for t in slabs], dst=0)
        if not self.is_controller:
            return None
        out = np.empty(shape, local.numpy().dtype)
        for at, slab in zip(self._coords, slabs):
            out[part.index_at(shape, at)] = slab.numpy()
        return out

    def follow(self) -> int:
        """A non-controller rank's loop: run every tick the controller
        announces, on the replica of this runner's fleet the header names
        (this runner alone unless ``link_replicas`` linked it), until the
        controller closes; returns the ticks run."""
        if not self._ranked or self.is_controller:
            raise RuntimeError("only a rank other than 0 of a ranked runner follows")
        fleet = self._replicas()
        ticks = 0
        while True:
            kind, bucket, replica = self._header()
            if kind == _STOP:
                return ticks
            runner = fleet[replica] if 0 <= replica < len(fleet) else None
            if runner is None:
                raise RuntimeError(f"rank {self.rank} holds no replica {replica} of the "
                                   f"{len(fleet)} the controller may announce: link every "
                                   f"rank's runners alike and keep them")
            if kind != runner._kind:
                raise RuntimeError(f"rank {self.rank} runs forward kind {runner._kind}, the "
                                   f"controller announced {kind}: construct every rank's "
                                   f"runner alike")
            runner._tick(bucket, None)
            ticks += 1

    def close(self) -> None:
        """The controller tells the followers to stop, once for the runners
        ``link_replicas`` linked; nothing to do on one device or on a
        follower."""
        if self._ranked and self.is_controller and not self._closed:
            self._header(_STOP)
            for r in self._replicas():
                if r is not None:
                    r._closed = True

    def _replicas(self) -> list:
        """The runners linked with this one, by replica index (None for one
        that no longer exists)."""
        return [self] if self._fleet is None else [ref() for ref in self._fleet]

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
        t0 = time.perf_counter()
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
        staged_s = time.perf_counter() - t0
        yb = self._batch_forward(*batch)
        self.tick_times[-1]["stage"] = staged_s
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


def link_replicas(runners: Sequence[FNORunner]) -> None:
    """Let R runners share one start of the ranks as R gateway replicas.

    Every rank builds its runners alike and in the same order, then links
    them: replica i's ticks name i in the header, a follower's ``follow``
    (on any of them) runs each announced tick on the replica it names and
    no other, and the controller's ``close`` (on any of them, once the
    gateway has drained) stops that loop once. A replica that raises on
    the controller before its header leaves the followers waiting for the
    next one, so they stay in step. Runners on one device may be linked
    too; the link changes nothing there.
    """
    runners = tuple(runners)
    if len({id(r) for r in runners}) != len(runners):
        raise ValueError("each replica needs its own runner instance")
    if len({r._ranked for r in runners}) > 1:
        raise ValueError("link ranked runners with ranked runners only")
    for r in runners:
        if r._closed:
            raise ValueError("a closed runner cannot join a fleet")
    refs = tuple(weakref.ref(r) for r in runners)
    for i, r in enumerate(runners):
        r.replica, r._fleet = i, refs
