"""What each rank of ``tests/test_torch_dist.py``'s launch runs.

Kept apart from the test module so the spawned ranks import torch and the
port only, never JAX. ``run_checks`` runs on every one of 4 gloo ranks on
the CPU: the rank-local checks of the repartition operator, the partition
descriptors (tuple dims included), the groups' rank order and the
parameter sharding, then the distributed forward on two 1-D layouts
(every schedule) and two 2-D pencil layouts (paper and eager), with
``comm_chunks`` 1 and 2, and its gradients. Rank 0 returns the gathered
global outputs and gradients, which the test holds against the JAX
reference in its own process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fno
from repro_torch.core.partition import CartPartition, gather, gather_dim, local_slice, shard
from repro_torch.core.repartition import (
    repartition, repartition_chunked, repartition_multi, repartition_multi_t, repartition_t,
)
from repro_torch.launch.mesh import build_fno_groups, dp_axes_for

VARIANTS = ("paper", "eager", "grady31")
VARIANTS_2D = ("paper", "eager")  # the schedules with a pencil form
# data x model ranks, by --model-shards: one value 1-D, two the pencils
LAYOUTS = {"1x4": [4], "2x2": [2], "1x2x2": [2, 2], "1x1x4": [1, 4]}
CHUNKED_LAYOUTS = ("1x4", "1x2x2")            # also run with comm_chunks=2
GRAD_LAYOUTS = ("1x4", "1x2x2", "1x1x4")      # also differentiated
CHUNKS = (1, 2, 3, 6, 16)


@contextlib.contextmanager
def one_launch_at_a_time():
    """Holds a lock file in the temp directory while a test launches its
    ranks, so the 4-rank launches of ``tests/test_torch_dist.py`` and
    ``tests/test_torch_dist_train.py`` take turns on the CPU's cores
    when pytest-xdist runs the two modules at once."""
    with open(os.path.join(tempfile.gettempdir(), "repro_torch_rank_launch.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def variants_of(layout: str) -> tuple:
    return VARIANTS if len(LAYOUTS[layout]) == 1 else VARIANTS_2D


class _Checks:
    """Each check's result on this rank: (passed, detail)."""

    def __init__(self):
        self.results = {}

    def run(self, name, fn):
        try:
            detail = fn()
            self.results[name] = (True, "" if detail is None else str(detail))
        except Exception:  # noqa: BLE001 - recorded for the test to report
            self.results[name] = (False, traceback.format_exc())

    def require(self, cond, what):
        if not cond:
            raise AssertionError(what)


def _cplx(rng, shape):
    return torch.from_numpy(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    )


def _repartition_checks(c: _Checks, group):
    p, r = dist.get_world_size(group), dist.get_rank(group)
    rng = np.random.default_rng(0)  # the same global tensors on every rank
    g = _cplx(rng, (2, 8, 16))
    a = local_slice(g, 1, group).contiguous()

    def lands_like_all_to_all():
        # jax.lax.all_to_all(split_axis=dst, concat_axis=src, tiled=True)
        c.require(torch.equal(repartition(a, 1, 2, group), local_slice(g, 2, group)),
                  "3-D repartition(1 -> 2) is not the global tensor sharded along dim 2")
        x6 = _cplx(rng, (2, 3, 8, 12, 4, 5))
        got = repartition(local_slice(x6, 2, group).contiguous(), 2, 3, group)
        c.require(torch.equal(got, local_slice(x6, 3, group)),
                  "6-D repartition(x -> y) is not the global tensor sharded along y")
        back = repartition(local_slice(x6, 3, group).contiguous(), 3, 2, group)
        c.require(torch.equal(back, local_slice(x6, 2, group)), "6-D repartition(y -> x)")
        real = torch.randn(4, 8, 2, generator=torch.Generator().manual_seed(1))
        c.require(torch.equal(repartition(local_slice(real, 0, group).contiguous(), 0, 1, group),
                              local_slice(real, 1, group)), "float32 repartition(0 -> 1)")

    def roundtrip_bitwise():
        y = repartition(a, 1, 2, group)
        c.require(torch.equal(repartition(y, 2, 1, group), a), "R_{2->1} R_{1->2} != I")
        c.require(torch.equal(repartition_t(y, 1, 2, group), a), "repartition_t is not the inverse")

    def adjoint_dot():
        ra = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(10 + r))
        rb = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(20 + r))
        ra, rb = local_slice(ra, 1, group).contiguous(), local_slice(rb, 1, group).contiguous()
        dots = torch.stack([torch.vdot(repartition(ra, 1, 2, group).flatten(),
                                       repartition(rb, 1, 2, group).flatten()),
                            torch.vdot(ra.flatten(), rb.flatten())]).double()
        dist.all_reduce(dots, group=group)
        np.testing.assert_allclose(float(dots[0]), float(dots[1]), rtol=1e-5)
        return f"<Ra,Rb>={float(dots[0]):.6f} <a,b>={float(dots[1]):.6f}"

    def transpose_is_inverse():
        y = repartition(a, 1, 2, group)
        np.testing.assert_allclose(repartition(y, 2, 1, group).numpy(), a.numpy(), rtol=1e-6)
        # the autograd backward of R is R^T: <R^T gy, a> = <gy, R a>
        leaf = a.clone().requires_grad_()
        gy = _cplx(np.random.default_rng(30 + r), tuple(y.shape))
        out = repartition(leaf, 1, 2, group)
        (out.real * gy.real + out.imag * gy.imag).sum().backward()
        c.require(torch.equal(leaf.grad, repartition(gy, 2, 1, group)),
                  "autograd backward of repartition is not the reverse move")

    def multi():
        x6 = local_slice(_cplx(rng, (2, 4, 8, 8, 4, 3)), 2, group).contiguous()
        moves = [(2, 3, group), (3, 4, group)]
        y = repartition_multi(x6, moves)
        c.require(y.shape == (2, 4, 8, 8, 4 // p, 3), f"multi shape {tuple(y.shape)}")
        c.require(torch.equal(repartition_multi_t(y, moves), x6), "multi_t(multi(x)) != x")

    c.run("repartition_lands_like_jax_all_to_all", lands_like_all_to_all)
    c.run("repartition_roundtrip_bitwise", roundtrip_bitwise)
    c.run("repartition_adjoint_dot", adjoint_dot)
    c.run("repartition_transpose_is_inverse", transpose_is_inverse)
    c.run("repartition_multi_roundtrip", multi)
    x6 = local_slice(_cplx(rng, (2, 7, 8, 12, 4, 5)), 2, group).contiguous()
    want = repartition(x6, 2, 3, group)
    for n in CHUNKS:
        c.run(f"repartition_chunked_{n}_bitwise", lambda n=n: c.require(
            torch.equal(repartition_chunked(x6, 2, 3, group, chunks=n), want),
            f"chunks={n} differs from the unchunked repartition"))


def _partition_checks(c: _Checks, groups):
    def with_moved_and_validate():
        part = CartPartition(("data", None, "model", None, None, None))
        c.require(part.sharded_dims() == (0, 2) and part.axis_of(2) == "model", "descriptors")
        moved = part.with_moved(2, 3)
        c.require(moved.dims == ("data", None, None, "model", None, None), f"moved {moved.dims}")
        c.require(part.with_moved(2, 3, axis="model") == moved, "axis= names the moving group")
        # the 2-D pencil forward's moves: R^{my}_{y->z}, then R^{mx}_{x->y}
        pencil = CartPartition(("data", None, "mx", "my", None, None))
        spectral = pencil.with_moved(3, 4).with_moved(2, 3)
        c.require(spectral.dims == ("data", None, None, "mx", "my", None), f"pencil {spectral.dims}")
        # a move onto a sharded dim appends its group, innermost; axis= picks it back out
        both = pencil.with_moved(2, 3, axis="mx")
        c.require(both.dims == ("data", None, None, ("my", "mx"), None, None), f"tuple {both.dims}")
        c.require(both.with_moved(3, 2, axis="mx") == pencil, "moving mx back")
        for bad, words in ((lambda: part.with_moved(1, 3), "not sharded"),
                           (lambda: part.with_moved(2, 3, axis="data"), "not sharded by"),
                           (lambda: both.with_moved(3, 4), "name the axis"),
                           (lambda: both.with_moved(3, 2, axis="model"), "not sharded by"),
                           (lambda: CartPartition((None, None, "mx", "mx", None, None))
                            .with_moved(2, 3), "already sharded by")):
            try:
                bad()
            except ValueError as e:
                c.require(words in str(e), f"message {e!r} lacks {words!r}")
            else:
                raise AssertionError(f"no ValueError ({words})")
        part.validate((2, 1, 16, 5, 3, 1), groups)
        try:
            part.validate((2, 1, 6, 5, 3, 1), groups)
        except ValueError as e:
            c.require("not divisible" in str(e), str(e))
        else:
            raise AssertionError("validate passed a dim 6 over 4 ranks")

    def shard_gather_roundtrip():
        x = _cplx(np.random.default_rng(5), (2, 3, 8, 4, 2, 3))
        part = CartPartition(("data", None, "model", None, None, None))
        local = shard(x, part, groups)
        c.require(local.shape[2] == 8 // dist.get_world_size(groups["model"]), "local shape")
        c.require(torch.equal(gather(local, part, groups), x), "gather(shard(x)) != x")
        c.require(torch.equal(gather_dim(local_slice(x, 3, groups["model"]).contiguous(), 3,
                                         groups["model"]), x), "gather_dim")

    c.run("cart_partition_with_moved_and_validate", with_moved_and_validate)
    c.run("shard_gather_roundtrip_bitwise", shard_gather_roundtrip)


def _pencil_checks(c: _Checks, params, world_size):
    """The (1 x 2 x 2) groups: rank order, tuple-dim shards, and the
    pencil shard of w_spec against its k_y x k_z block directly."""
    data_group, model, _ = build_fno_groups(world_size, [2, 2])
    groups = fno.group_names(data_group, model)
    me = dist.get_rank()

    def rank_order():
        i, j = dist.get_rank(groups["mx"]), dist.get_rank(groups["my"])
        c.require(me == i * 2 + j, f"rank {me} is (mx {i}, my {j}), not row-major (data, mx, my)")
        c.require(dist.get_world_size(groups["data"]) == 1, "one data rank")
        c.require(dp_axes_for(groups) == ("data",), f"data-parallel axes {dp_axes_for(groups)}")
        w = params["blocks"]["w_spec"]
        ky, kz = w.shape[4] // 2, w.shape[5] // 2
        want = w[..., i * ky:(i + 1) * ky, j * kz:(j + 1) * kz, :]
        c.require(torch.equal(fno.shard_params(params, model)["blocks"]["w_spec"], want),
                  "the w_spec shard is not the rank's (k_y run i, k_z run j) block")

    def tuple_dims():
        x = _cplx(np.random.default_rng(6), (2, 3, 8, 4, 4, 3))
        part = CartPartition((None, None, ("mx", "my"), None, None, None))
        local = shard(x, part, groups)
        piece = dist.get_rank(groups["mx"]) * 2 + dist.get_rank(groups["my"])
        c.require(torch.equal(local, x[:, :, 2 * piece:2 * piece + 2]),
                  "a dim split by (mx, my) is not laid out as P(('mx', 'my'))")
        c.require(torch.equal(gather(local, part, groups), x), "gather(shard(x)) != x, tuple dim")
        pencil = CartPartition((None, None, "mx", "my", None, None))
        c.require(torch.equal(gather(shard(x, pencil, groups), pencil, groups), x),
                  "gather(shard(x)) != x, pencil")
        moved = pencil.with_moved(2, 3, axis="mx")
        y = shard(x, pencil, groups)
        c.require(torch.equal(repartition(y, 2, 3, groups["mx"]), shard(x, moved, groups)),
                  "R^{mx}_{x->y} does not land as with_moved describes")
        back = fno.gather_params(fno.shard_params(params, model), model)
        for group_name, leaves in params.items():
            for name, t in leaves.items():
                c.require(torch.equal(back[group_name][name], t), f"{group_name}.{name} differs")

    c.run("pencil_groups_are_row_major_and_shard_w_spec_by_k_y_k_z", rank_order)
    c.run("shard_gather_tuple_dims_and_pencil_params_roundtrip_bitwise", tuple_dims)


def _refusal_checks(c: _Checks, cfg, model_group):
    def refuses():
        data_group, pair, n_model = build_fno_groups(4, [2, 2])  # pencils work
        c.require(n_model == 4 and len(pair) == 2, f"pencil groups {pair!r}")
        pair_1x4 = build_fno_groups(4, [1, 4])[1]
        c.require(fno.input_spec("data", ("mx", "my")).dims == ("data", None, "mx", "my", None, None),
                  "pencil input_spec")
        fno.make_dist_forward(cfg, pair, variant="eager")
        for bad, words in (
            (lambda: build_fno_groups(4, [3]), "not divisible"),
            (lambda: build_fno_groups(4, [3, 2]), "not divisible"),
            (lambda: build_fno_groups(4, [1, 2, 2]), "1 (x-decomposition) or 2"),
            (lambda: fno.make_dist_forward(cfg, pair, variant="grady31"), "no 2-D schedule"),
            (lambda: fno.make_dist_forward(cfg, (model_group,) * 3), "2 model groups"),
            (lambda: fno.make_dist_forward(dataclasses.replace(cfg, modes=(4, 4, 3, 3)), pair_1x4),
             "2*mz=6 not divisible by 4 y-shards"),
            (lambda: fno.make_dist_forward(cfg, None), "every rank"),
            (lambda: fno.make_dist_forward(cfg, model_group, variant="pencil"), "unknown variant"),
            (lambda: fno.make_dist_forward(dataclasses.replace(cfg, modes=(4, 3, 2, 3)),
                                           model_group), "2*my=6 not divisible"),
        ):
            try:
                bad()
            except ValueError as e:
                c.require(words in str(e), f"message {e!r} lacks {words!r}")
            else:
                raise AssertionError(f"no ValueError ({words})")

    c.run("refuses_pencils_and_bad_model_shards", refuses)


def _one_shard_checks(c: _Checks, world_size):
    """``--model-shards 1``: each rank's model group holds that rank alone
    (never None, which torch.distributed reads as every rank), and the data
    group every rank."""
    data_group, model_group, n_model = build_fno_groups(world_size, [1])

    def own_group():
        c.require(n_model == 1 and model_group is not None, f"model group {model_group!r}")
        c.require(dist.get_world_size(model_group) == 1 and dist.get_rank(model_group) == 0,
                  f"model group of {dist.get_world_size(model_group)} ranks")
        c.require(dist.get_world_size(data_group) == world_size, "data group")
        x = _cplx(np.random.default_rng(7), (2, 3, 4, 4, 2, 3))
        c.require(torch.equal(repartition(x, 2, 3, model_group), x),
                  "a repartition over one rank is not the identity")

    c.run("model_shards_1_gives_each_rank_its_own_group", own_group)


def _global_grads(grads: dict, groups: dict) -> dict:
    """Every leaf's gradient of the global loss from this rank's partial
    ones: replicated leaves summed over all ranks, w_spec's shards summed
    over the data group and gathered over the model group(s)."""
    model_names = [n for n in groups if n != "data"]
    part = fno.W_SPEC_PARTITION_2D if "mx" in groups else fno.W_SPEC_PARTITION
    out = {}
    for group_name, leaves in grads.items():
        out[group_name] = {}
        for name, t in leaves.items():
            t = t.clone()
            dist.all_reduce(t, group=groups["data"])
            if name == "w_spec":
                t = gather(t, part, groups)
            else:
                for n in model_names:
                    dist.all_reduce(t, group=groups[n])
            out[group_name][name] = t
    return out


def run_checks(rank, world_size, device, params_np, x_np, cfg_kwargs):
    """One rank's share of the suite; returns (check results, rank 0's
    global outputs and gradients)."""
    c = _Checks()
    c.run("rank_runs_one_thread", lambda: c.require(
        torch.get_num_threads() == 1, f"{torch.get_num_threads()} threads"))
    cfg = fno.FNOConfig(**cfg_kwargs)
    params = fno.params_from_numpy(params_np, device)
    x = torch.from_numpy(x_np).to(device)
    outputs, grads = {}, {}
    for layout, shards in LAYOUTS.items():
        data_group, model, _ = build_fno_groups(world_size, shards)
        groups = fno.group_names(data_group, model)
        part = fno.input_spec("data", fno.model_axes(model))
        if layout == "1x4":
            _repartition_checks(c, model)
            _partition_checks(c, groups)
            _refusal_checks(c, cfg, model)
            _one_shard_checks(c, world_size)
            c.run("shard_gather_params_roundtrip_bitwise",
                  lambda mg=model: _params_roundtrip(c, params, mg))
        elif layout == "1x2x2":
            _pencil_checks(c, params, world_size)
        local = fno.shard_params(params, model)
        local_x = shard(x, part, groups)
        for variant in variants_of(layout):
            for chunks in ((1, 2) if layout in CHUNKED_LAYOUTS else (1,)):
                fwd = fno.make_dist_forward(dataclasses.replace(cfg, comm_chunks=chunks),
                                            model, variant=variant)
                with torch.no_grad():
                    y = gather(fwd(local, local_x), part, groups)
                outputs[f"{variant}_{layout}_chunks{chunks}"] = y
            if layout in GRAD_LAYOUTS:
                leaves = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
                          for k, v in local.items()}
                y_local = fno.make_dist_forward(cfg, model, variant=variant)(leaves, local_x)
                (y_local.square().sum() / x[:, :1].numel()).backward()
                grads[f"{variant}_{layout}"] = _global_grads(
                    {k: {n: t.grad for n, t in v.items()} for k, v in leaves.items()}, groups)
    if rank != 0:
        outputs, grads = {}, {}
    return {"checks": c.results, "outputs": outputs, "grads": grads}


def _params_roundtrip(c: _Checks, params, model_group):
    local = fno.shard_params(params, model_group)
    p = dist.get_world_size(model_group)
    c.require(local["blocks"]["w_spec"].shape[4] == params["blocks"]["w_spec"].shape[4] // p,
              f"w_spec shard {tuple(local['blocks']['w_spec'].shape)}")
    back = fno.gather_params(local, model_group)
    for group_name, leaves in params.items():
        for name, t in leaves.items():
            c.require(torch.equal(back[group_name][name], t), f"{group_name}.{name} differs")


RANK_CHECK_NAMES = (
    "rank_runs_one_thread",
    "repartition_lands_like_jax_all_to_all",
    "repartition_roundtrip_bitwise",
    "repartition_adjoint_dot",
    "repartition_transpose_is_inverse",
    "repartition_multi_roundtrip",
    *(f"repartition_chunked_{n}_bitwise" for n in CHUNKS),
    "cart_partition_with_moved_and_validate",
    "shard_gather_roundtrip_bitwise",
    "refuses_pencils_and_bad_model_shards",
    "model_shards_1_gives_each_rank_its_own_group",
    "shard_gather_params_roundtrip_bitwise",
    "pencil_groups_are_row_major_and_shard_w_spec_by_k_y_k_z",
    "shard_gather_tuple_dims_and_pencil_params_roundtrip_bitwise",
)


def fail_on_rank_1(rank, world_size, device):
    """A rank function whose rank 1 raises (the launcher must raise)."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def hang(rank, world_size, device):
    """A rank function that outlives any short deadline."""
    import time

    time.sleep(600)


def collectives_for(rank, world_size, device, seconds):
    """All-reduces, one every 50 ms, until rank 0's clock passes
    ``seconds``; returns how many ran (the same on every rank)."""
    import time

    t0, n = time.monotonic(), 0
    flag = torch.zeros(1)
    while True:
        flag.fill_(float(rank == 0 and time.monotonic() - t0 > seconds))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        n += 1
        if flag.item():
            return n
        time.sleep(0.05)
