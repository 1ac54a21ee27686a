"""What each rank of ``tests/test_torch_dist_serve.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_serve_checks`` runs on every one of 4 gloo
ranks on the CPU: the split and deep-split distributed forwards under
every schedule on (1 data x 4 model), (2 x 2) and (1 x 2x2 pencils), two
deep forwards fed a wrongly scattered contribution, then ``FNORunner``
over the (2 x 2) and (1 x 2x2) rank groups, plain, ``prelift`` and
``deep``, the last two served cold (no cache) and twice warm, and the
runner's refusals. Rank 0 returns the gathered outputs and what it
served, which the test holds against the JAX reference in its own process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import fno
from repro_torch.core.partition import CartPartition, gather, shard
from repro_torch.data.loader import Normalizer
from repro_torch.launch.mesh import build_fno_groups
from repro_torch.serve import FNORunner, ScenarioRequest, Scheduler
from torch_dist_checks import VARIANTS, VARIANTS_2D, _Checks

N_STATIC = 1
# data x model ranks, by --model-shards: one value 1-D, two the pencils
LAYOUTS = {"1x4": [4], "2x2": [2], "1x2x2": [2, 2]}
RUNNER_LAYOUTS = ("2x2", "1x2x2")
# (name, n_static, cache level) of the served runners
RUNNER_KINDS = (("plain", 0, "deep"), ("prelift", N_STATIC, "prelift"),
                ("deep", N_STATIC, "deep"))
SERVE_STEPS, MAX_SLOTS = 2, 2


def variants_of(layout: str) -> tuple:
    return VARIANTS if len(LAYOUTS[layout]) == 1 else VARIANTS_2D


def _serve(runner, xs) -> list:
    """Serve every input for ``SERVE_STEPS`` rollout steps; each request's
    outputs, by rid."""
    sched = Scheduler(runner, MAX_SLOTS)
    reqs = [ScenarioRequest(rid=i, x=x.copy(), steps=SERVE_STEPS) for i, x in enumerate(xs)]
    for r in reqs:
        sched.submit(r)
    done = sched.run_until_done(max_steps=100)
    if sched.failed or len(done) != len(reqs):
        raise RuntimeError(f"served {len(done)}/{len(reqs)}: {[r.error for r in sched.failed]}")
    return [[torch.from_numpy(y) for y in r.outputs] for r in sorted(done, key=lambda r: r.rid)]


def _on_ranks(runner, xs, passes: int, warmup: bool = False):
    """Rank 0 serves ``xs`` ``passes`` times (after a warmup, if asked)
    and closes; every other rank follows. Returns (rank 0's passes or
    None, the ticks this rank ran)."""
    if not runner.is_controller:
        return None, runner.follow()
    if warmup:
        runner.warmup()
    out = [_serve(runner, xs) for _ in range(passes)]
    runner.close()
    return out, len(runner.tick_times)


def _forwards(cfg, params, inputs, layout, shards, world_size, outputs):
    data_group, model, _ = build_fno_groups(world_size, shards)
    groups = fno.group_names(data_group, model)
    axes = fno.model_axes(model)
    x_part, c_part = fno.input_spec("data", axes), fno.contrib_spec("data", axes)
    local = fno.shard_params(params, model)
    pre, xd = (shard(inputs[k], x_part, groups) for k in ("pre_static", "x_dyn"))
    contrib = shard(inputs["contrib"], c_part, groups)
    with torch.no_grad():
        for variant in variants_of(layout):
            split = fno.make_dist_forward_split(cfg, N_STATIC, model, variant=variant)
            deep = fno.make_dist_forward_deep_split(cfg, N_STATIC, model, variant=variant)
            outputs[f"split_{variant}_{layout}"] = gather(split(local, pre, xd), x_part, groups)
            outputs[f"deep_{variant}_{layout}"] = gather(deep(local, contrib, pre, xd), x_part,
                                                         groups)
        # negative controls: the contribution scattered along the wrong mode
        # dims (pencils), or each rank given its neighbour's k_y shard (1-D)
        deep = fno.make_dist_forward_deep_split(cfg, N_STATIC, model, variant="paper")
        if layout == "1x2x2":
            swapped = CartPartition(("data", None, None, "my", "mx", None))
            wrong = shard(inputs["contrib"], swapped, groups)
            outputs["wrong_contrib_k_y_k_z_swapped_1x2x2"] = gather(
                deep(local, wrong, pre, xd), x_part, groups)
        elif layout == "1x4":
            ky = inputs["contrib"].shape[3]
            rolled = torch.roll(inputs["contrib"], ky // 4, dims=3)
            outputs["wrong_contrib_neighbouring_k_y_shard_1x4"] = gather(
                deep(local, shard(rolled, c_part, groups), pre, xd), x_part, groups)


def _runners(c: _Checks, cfg, params, xs, norms, layout, shards, world_size, device, served):
    data_group, model, _ = build_fno_groups(world_size, shards)
    local = fno.shard_params(params, model)
    common = dict(device=device, data_group=data_group, model=model, max_slots=MAX_SLOTS,
                  x_normalizer=norms[0], y_normalizer=norms[1])
    ticks = {}
    for name, n_static, level in RUNNER_KINDS:
        warm = FNORunner(cfg, local, n_static=n_static, cache_level=level, **common)
        passes, ticks[f"{name}_warm"] = _on_ranks(warm, xs, 2 if n_static else 1,
                                                  warmup=name == "plain")
        entry = {"passes": passes}
        if n_static:
            cold = FNORunner(cfg, local, n_static=n_static, cache_level=level, cache=None,
                             **common)
            entry["cold"], ticks[f"{name}_cold"] = _on_ranks(cold, xs, 1)
            entry["cold"] = entry["cold"] and entry["cold"][0]
            entry["stats"] = warm.cache.stats if warm.cache is not None else None
        if dist.get_rank() == 0:
            entry["buckets"] = list(warm.buckets)
            served[f"{name}_{layout}"] = entry
    # every rank ran the ticks rank 0 ran
    counts = [None] * world_size
    dist.all_gather_object(counts, ticks)
    c.run(f"every_rank_runs_rank_0s_ticks_{layout}", lambda: c.require(
        all(t == counts[0] for t in counts), f"ticks per rank {counts}"))
    return local, data_group, model


def _forward_refusals(c: _Checks, cfg, world_size):
    """The split forwards refuse what ``make_dist_forward`` refuses."""
    def refuses():
        _, pair, _ = build_fno_groups(world_size, [2, 2])
        _, group, _ = build_fno_groups(world_size, [4])
        for make in (fno.make_dist_forward_split, fno.make_dist_forward_deep_split):
            for args, kw, words in (((None,), {}, "every rank"),
                                    ((pair,), dict(variant="grady31"), "no 2-D schedule"),
                                    ((group,), dict(variant="pencil"), "unknown variant"),
                                    (((group,) * 3,), {}, "2 model groups")):
                try:
                    make(cfg, N_STATIC, *args, **kw)
                except ValueError as e:
                    c.require(words in str(e), f"{make.__name__}: {e!r} lacks {words!r}")
                else:
                    raise AssertionError(f"{make.__name__}: no ValueError ({words})")

    c.run("split_forwards_refuse_bad_groups_and_variants", refuses)


def _from_jax_checkpoint(c: _Checks, ckpt_dir, xs, world_size, device, served):
    """A checkpoint the JAX trainer wrote, restored onto the pencils (each
    rank reading its region of ``w_spec``) and served."""
    data_group, model, _ = build_fno_groups(world_size, LAYOUTS["1x2x2"])
    runner = FNORunner.from_checkpoint(ckpt_dir, device=device, data_group=data_group,
                                       model=model, max_slots=MAX_SLOTS)
    c.run("from_jax_checkpoint_restores_this_ranks_w_spec_shard", lambda: c.require(
        tuple(runner.params["blocks"]["w_spec"].shape[4:6]) == (4, 2),
        f"w_spec shard {tuple(runner.params['blocks']['w_spec'].shape)}"))
    passes, _ = _on_ranks(runner, xs, 1)
    if runner.is_controller:
        served["from_jax_checkpoint_1x2x2"] = {"passes": passes, "step": runner.restored_step,
                                               "buckets": list(runner.buckets)}


def _refusals(c: _Checks, cfg, params, local, data_group, model, device):
    def refuses():
        for kw, words in (
                (dict(params=local, buckets=(1, 2)), "not divisible by data-parallel size 2"),
                (dict(params=local, buckets=(2,), max_slots=4), "largest bucket 2 < max_slots 4"),
                (dict(params=params), "is not this rank's shard"),
                (dict(params=local, data_group=None), "or neither")):
            kw = dict(dict(device=device, data_group=data_group, model=model), **kw)
            try:
                FNORunner(cfg, kw.pop("params"), **kw)
            except ValueError as e:
                c.require(words in str(e), f"message {e!r} lacks {words!r}")
            else:
                raise AssertionError(f"no ValueError ({words})")

    c.run("runner_refuses_bad_buckets_and_shards_2x2", refuses)


def run_serve_checks(rank, world_size, device, params_np, inputs_np, xs, cfg_kwargs, stats,
                     jax_ckpt_dir):
    """One rank's share; returns (check results, rank 0's gathered forward
    outputs and served requests)."""
    c = _Checks()
    cfg = fno.FNOConfig(**cfg_kwargs)
    params = fno.params_from_numpy(params_np, device)
    inputs = {k: torch.from_numpy(v).to(device) for k, v in inputs_np.items()}
    norms = (Normalizer.from_stats(stats["x"], "meanstd"), Normalizer.from_stats(stats["y"],
                                                                                 "meanstd"))
    outputs, served = {}, {}
    for layout, shards in LAYOUTS.items():
        _forwards(cfg, params, inputs, layout, shards, world_size, outputs)
    _forward_refusals(c, cfg, world_size)
    for layout in RUNNER_LAYOUTS:
        local, data_group, model = _runners(c, cfg, params, xs, norms, layout, LAYOUTS[layout],
                                            world_size, device, served)
        if layout == "2x2":
            _refusals(c, cfg, params, local, data_group, model, device)
    _from_jax_checkpoint(c, jax_ckpt_dir, xs, world_size, device, served)
    if rank != 0:
        outputs, served = {}, {}
    return {"checks": c.results, "outputs": outputs, "served": served}


RANK_CHECK_NAMES = (
    *(f"every_rank_runs_rank_0s_ticks_{layout}" for layout in RUNNER_LAYOUTS),
    "runner_refuses_bad_buckets_and_shards_2x2",
    "split_forwards_refuse_bad_groups_and_variants",
    "from_jax_checkpoint_restores_this_ranks_w_spec_shard",
)
