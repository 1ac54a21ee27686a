"""The port's domain-decomposed FNO (1-D and 2-D pencils) vs the JAX
package, on the CPU.

One launch of 4 gloo ranks (``repro_torch.launch.mesh.launch_ranks``: a
``FileStore`` rendezvous, one thread a rank, a 240 s deadline) runs
``tests/torch_dist_checks.py``: the repartition operator, the partition
descriptors (tuple dims too), parameter sharding and the distributed
forward under every 1-D schedule (paper, eager, grady31) on a (1 data x 4
model) and a (2 x 2) layout and under the pencil schedules (paper, eager)
on (1 x 2x2) and (1 x 1x4), with ``comm_chunks`` 1 and 2, and its
gradients. This process then
holds the gathered outputs against the JAX package's unfused serial
``fno_forward`` (``use_pallas=False``, as ``tests/distributed_checks.py``
does) on the same numpy parameters and input, writes every check's result
to one JSON file, and each case below reads its entry.

Gates: forwards rtol 1e-4, atol 1e-5; ``comm_chunks=2`` vs unchunked rtol
1e-6, atol 1e-7; gradients vs the JAX serial ones rtol 5e-3, atol 5e-5
(``tests/distributed_checks.py:86-91``) and vs the port's serial fused
ones rtol 1e-4, atol 1e-5, each atol at most 1e-3 of its leaf's max|ref|
(most of w_spec's gradient lies below 5e-5); repartitions and round trips
bitwise. The gradient gate is shown to refuse a zeroed w_spec gradient,
k_y shards one rank off, and ci/co swapped, and on the pencils the k_y or
k_z shards one rank off.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_checks as rank_side
from repro.core import fno as jfno
from repro_torch.core import fno as tfno
from repro_torch.launch.mesh import launch_ranks

CFG = dict(grid=(16, 16, 8, 8), modes=(4, 4, 2, 3), width=6, in_channels=2,
           out_channels=1, n_blocks=2, decoder_dim=8)
BATCH = 2
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK_TOL = dict(rtol=1e-6, atol=1e-7)
GRAD_TOL = dict(rtol=5e-3, atol=5e-5)
FUSED_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LEAF_ATOL = 1e-3  # a gradient leaf's atol is at most this share of its max|ref|
TIMEOUT_S = 240

RUNS = [(v, layout) for layout in rank_side.LAYOUTS for v in rank_side.variants_of(layout)]
PARITY_CHECKS = (
    *(f"forward_{v}_{layout}_vs_jax_serial" for v, layout in RUNS),
    *(f"forward_{v}_{layout}_comm_chunks_2_vs_unchunked" for v, layout in RUNS
      if layout in rank_side.CHUNKED_LAYOUTS),
    *(f"grads_{v}_{layout}_vs_jax_serial" for v, layout in RUNS
      if layout in rank_side.GRAD_LAYOUTS),
    "grads_paper_1x4_vs_port_serial_fused",
    "grads_paper_1x2x2_vs_port_serial_fused",
    *(f"grads_gate_refuses_{wrong}" for wrong in
      ("zeroed_w_spec", "k_y_shards_one_rank_off", "ci_co_swapped")),
    *(f"grads_gate_refuses_pencil_{wrong}" for wrong in
      ("k_y_shards_one_rank_off", "k_z_shards_one_rank_off")),
)
CHECKS = rank_side.RANK_CHECK_NAMES + PARITY_CHECKS


def _compare(got, want, tol) -> dict:
    got, want = np.asarray(got), np.asarray(want)
    try:
        np.testing.assert_allclose(got, want, **tol)
    except AssertionError as e:
        return {"ok": False, "detail": str(e)}
    return {"ok": True, "detail": f"max|d|={float(np.abs(got - want).max()):.3e}"}


def _compare_trees(got: dict, want: dict, tol) -> dict:
    """Every leaf at ``tol``, its atol cut to LEAF_ATOL of the leaf's max|ref|."""
    worst, failed = 0.0, []
    for group, leaves in want.items():
        for name, w in leaves.items():
            scale = float(np.abs(w).max())
            r = _compare(got[group][name], w, dict(tol, atol=min(tol["atol"], LEAF_ATOL * scale)))
            if not r["ok"]:
                failed.append(f"{group}.{name} (max|ref|={scale:.3e}): {r['detail']}")
            else:
                worst = max(worst, float(np.abs(np.asarray(got[group][name]) - w).max()))
    return {"ok": not failed, "detail": "\n".join(failed) or f"max|d|={worst:.3e}"}


def _refused(got: dict, want: dict, tol, leaf, wrong) -> dict:
    """The gradient gate applied to ``got`` with ``leaf`` replaced by
    ``wrong(leaf's gradient)``: passes when the gate refuses it."""
    group, name = leaf
    bad = {k: dict(v) for k, v in got.items()}
    bad[group][name] = wrong(np.asarray(bad[group][name]))
    r = _compare_trees(bad, want, tol)
    return {"ok": not r["ok"], "detail": "refused" if not r["ok"] else "the gate passed it"}


def _numpy_tree(tree: dict, conj: bool = False) -> dict:
    """Leaves as numpy; ``conj`` turns JAX's complex cotangents into torch's
    ``.grad`` convention (its conjugate)."""
    def leaf(a):
        a = np.asarray(a)
        return np.conj(a) if conj and np.iscomplexobj(a) else a
    return {k: {n: leaf(v) for n, v in leaves.items()} for k, leaves in tree.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    jcfg = jfno.FNOConfig(**CFG, use_pallas=False)
    params = jax.device_get(jfno.init_params(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).standard_normal((BATCH, CFG["in_channels"]) + CFG["grid"])
    x = x.astype(np.float32)

    t0 = time.perf_counter()
    with rank_side.one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_checks, 4, str(root), args=(params, x, CFG),
                             deadline_s=TIMEOUT_S, device="cpu")
    launch_s = time.perf_counter() - t0

    out = {}
    for name in rank_side.RANK_CHECK_NAMES:
        per_rank = [r["checks"].get(name, (False, "missing")) for r in ranks]
        bad = [f"rank {i}: {detail}" for i, (ok, detail) in enumerate(per_rank) if not ok]
        out[name] = {"ok": not bad, "detail": "\n".join(bad) or per_rank[0][1]}

    y_ser = jax.jit(lambda p, x: jfno.fno_forward(p, x, jcfg))(params, x)
    g_ser = _numpy_tree(jax.device_get(jax.jit(jax.grad(
        lambda p: jnp.mean(jfno.fno_forward(p, x, jcfg) ** 2)))(params)), conj=True)
    tparams = {k: {n: t.requires_grad_() for n, t in v.items()}
               for k, v in tfno.params_from_numpy(params, "cpu").items()}
    tfno.fno_forward(tparams, torch.from_numpy(x), tfno.FNOConfig(**CFG)).square().mean().backward()
    g_fused = {k: {n: t.grad.numpy() for n, t in v.items()} for k, v in tparams.items()}

    outputs, grads = ranks[0]["outputs"], ranks[0]["grads"]
    for v, layout in RUNS:
        out[f"forward_{v}_{layout}_vs_jax_serial"] = _compare(
            outputs[f"{v}_{layout}_chunks1"], y_ser, FWD_TOL)
        if layout in rank_side.CHUNKED_LAYOUTS:
            out[f"forward_{v}_{layout}_comm_chunks_2_vs_unchunked"] = _compare(
                outputs[f"{v}_{layout}_chunks2"], outputs[f"{v}_{layout}_chunks1"], CHUNK_TOL)
        if layout in rank_side.GRAD_LAYOUTS:
            out[f"grads_{v}_{layout}_vs_jax_serial"] = _compare_trees(
                _numpy_tree(grads[f"{v}_{layout}"]), g_ser, GRAD_TOL)
    for layout in ("1x4", "1x2x2"):
        out[f"grads_paper_{layout}_vs_port_serial_fused"] = _compare_trees(
            _numpy_tree(grads[f"paper_{layout}"]), g_fused, FUSED_GRAD_TOL)
    ky, kz = 2 * CFG["modes"][1], 2 * CFG["modes"][2]  # global k_y, k_z extents
    for prefix, layout, wrongs in (
            ("", "1x4", (("zeroed_w_spec", np.zeros_like),
                         ("k_y_shards_one_rank_off", lambda g: np.roll(g, ky // 4, axis=4)),
                         ("ci_co_swapped", lambda g: np.swapaxes(g, 1, 2)))),
            ("pencil_", "1x2x2", (("k_y_shards_one_rank_off", lambda g: np.roll(g, ky // 2, axis=4)),
                                  ("k_z_shards_one_rank_off", lambda g: np.roll(g, kz // 2, axis=5))))):
        for wrong, fn in wrongs:
            out[f"grads_gate_refuses_{prefix}{wrong}"] = _refused(
                _numpy_tree(grads[f"paper_{layout}"]), g_ser, GRAD_TOL, ("blocks", "w_spec"), fn)
    out["launch_seconds"] = launch_s
    path = root / "checks.json"
    path.write_text(json.dumps(out, indent=1))
    return path


@pytest.mark.parametrize("check", CHECKS)
def test_dist_fno_check(results, check):
    entry = json.loads(results.read_text()).get(check)
    assert entry is not None, f"{check} was not run"
    assert entry["ok"], entry["detail"]


def test_launcher_raises_on_a_failed_rank(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch_ranks(rank_side.fail_on_rank_1, 2, str(tmp_path), deadline_s=60, device="cpu")


def test_launcher_kills_ranks_past_its_deadline(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        launch_ranks(rank_side.hang, 2, str(tmp_path), deadline_s=5, device="cpu")
    assert time.perf_counter() - t0 < 60


def test_launch_outlives_its_collective_timeout_without_a_deadline(tmp_path):
    """The collective timeout bounds one wait for a peer, not the run: ranks
    that keep running collectives for over twice that long finish, and
    with no deadline nothing ends the launch."""
    timeout_s, run_s = 5, 12
    t0 = time.perf_counter()
    with rank_side.one_launch_at_a_time():
        counts = launch_ranks(rank_side.collectives_for, 4, str(tmp_path), args=(run_s,),
                              collective_timeout_s=timeout_s, device="cpu")
    assert time.perf_counter() - t0 >= 2 * timeout_s
    assert len(set(counts)) == 1 and counts[0] > 2 * timeout_s


def test_launch_past_its_deadline_raises_while_ranks_work(tmp_path):
    t0 = time.perf_counter()
    with rank_side.one_launch_at_a_time(), pytest.raises(TimeoutError):
        launch_ranks(rank_side.collectives_for, 4, str(tmp_path), args=(120,),
                     collective_timeout_s=5, deadline_s=15, device="cpu")
    assert time.perf_counter() - t0 < 60


def test_launcher_needs_a_card_unless_the_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_ranks(rank_side.fail_on_rank_1, 2, str(tmp_path))
