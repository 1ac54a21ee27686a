"""The port's GPipe pipeline and gradient compression vs the JAX package,
on the CPU.

One launch of 4 gloo ranks (``tests/torch_pipeline_checks.py``) runs the
pipeline in the configuration of the reference's
``pipeline_matches_serial`` (``tests/distributed_checks.py``: grid
16x16x8x8, modes 4,4,2,3, width 6, 4 blocks = 4 stages, batch 4, 2
micro-batches) and top-k compression with error feedback over the 4 ranks
as one data group. This process holds the results against the JAX
package:

- the forward on every rank against the JAX serial ``fno_forward`` at the
  reference's rtol 2e-4, atol 2e-5, and every rank's output equal to rank
  0's (replicated);
- the gradients of mean(y^2), the replicated leaves reduced over the
  stages, against the JAX serial gradients at the distributed gate (rtol
  5e-3, atol 5e-5, each atol at most 1e-3 of its leaf's max|ref|);
- exact calls of the spectral op's plain versions on every stage: 2 fused
  in the forward; 6 fused (forward, remat recompute, dx) and 2 dW in a
  forward + backward;
- the refusals, in the reference's words;
- compression (the reference's ``compressed_allreduce_error_feedback``
  cases): ratio 1.0 is the dense mean at rtol 1e-5, atol 1e-6 with a zero
  residual; at ratio 0.1 the reduced mean plus the mean residual is the
  dense mean at rtol 1e-4, atol 1e-5; each rank's top-k indices are those
  the reference's ``_topk_sparsify`` picks from the same gradients (real
  and complex), and the reduced values are the mean of the reference's
  sparse vectors within 1e-6; a leaf under 64 elements takes the dense
  mean.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_pipeline_checks as rank_side
from torch_dist_checks import one_launch_at_a_time
from repro.core import fno as jfno
from repro.core.pipeline import bubble_efficiency as jax_bubble_efficiency
from repro.train import compression as jcomp
from repro_torch.core.pipeline import bubble_efficiency
from repro_torch.launch.mesh import launch_ranks
from repro_torch.train import compression as tcomp

CFG = dict(grid=(16, 16, 8, 8), modes=(4, 4, 2, 3), width=6, in_channels=1, out_channels=1,
           n_blocks=4, decoder_dim=8)
BATCH, RANKS = 4, 4
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=5e-5)
LEAF_ATOL = 1e-3  # a gradient leaf's atol is at most this share of its max|ref|
TIMEOUT_S = 240

CHECKS = (
    "forward_vs_jax_serial", "forward_replicated_on_every_rank", "forward_calls_per_stage",
    "forward_trace_has_the_bubble", "grads_vs_jax_serial", "backward_calls_per_stage",
    "loss_equal_on_every_rank", "refuses_n_blocks_not_stages", "refuses_batch_not_divisible",
    "refuses_no_group", "compression_ratio_1_is_the_dense_mean",
    "compression_ratio_0.1_conserves", "compression_topk_sets_match_the_reference",
    "compression_complex_topk_sets_match_the_reference", "compression_tree_and_tiny_leaf",
)


def _compare(got, want, tol) -> dict:
    got, want = np.asarray(got), np.asarray(want)
    try:
        np.testing.assert_allclose(got, want, **tol)
    except AssertionError as e:
        return {"ok": False, "detail": str(e)}
    return {"ok": True, "detail": f"max|d|={float(np.abs(got - want).max()):.3e}"}


def _all(results) -> dict:
    bad = [r["detail"] for r in results if not r["ok"]]
    return {"ok": not bad, "detail": "\n".join(bad) or results[0]["detail"]}


def _check(cond, what) -> dict:
    return {"ok": bool(cond), "detail": what}


def _reference_sparse(g: np.ndarray, ratio: float):
    """(sorted top-k indices, dense sparse vector) of the reference's
    ``_topk_sparsify`` on one rank's gradient."""
    k = max(1, int(g.size * ratio))
    vals, idx = jcomp._topk_sparsify(jnp.asarray(g), k)
    flat = np.zeros(g.size, g.dtype)
    flat[np.asarray(idx)] = np.asarray(vals)
    return sorted(np.asarray(idx).tolist()), flat.reshape(g.shape)


def _compression_checks(ranks) -> dict:
    rng = np.random.default_rng(0)  # the draws torch_pipeline_checks makes
    g_all = rng.standard_normal((RANKS, 256)).astype(np.float32)
    c_all = (rng.standard_normal((RANKS, 8, 16))
             + 1j * rng.standard_normal((RANKS, 8, 16))).astype(np.complex64)
    tiny_all = rng.standard_normal((RANKS, 5)).astype(np.float32)
    comp = [r["compression"] for r in ranks]
    dense = g_all.mean(axis=0)
    out = {}
    r1 = [c["real_1.0"] for c in comp]
    out["compression_ratio_1_is_the_dense_mean"] = _all(
        [_compare(c["reduced"].numpy(), dense, dict(rtol=1e-5, atol=1e-6)) for c in r1]
        + [_check(not c["err"].numpy().any(), "residual is zero") for c in r1])
    r01 = [c["real_0.1"] for c in comp]
    mean_err = np.mean([c["err"].numpy() for c in r01], axis=0)
    out["compression_ratio_0.1_conserves"] = _all(
        [_compare(c["reduced"].numpy() + mean_err, dense, dict(rtol=1e-4, atol=1e-5))
         for c in r01])
    for key, data, name in (("real_0.1", g_all, "compression_topk_sets_match_the_reference"),
                            ("complex_0.1", c_all,
                             "compression_complex_topk_sets_match_the_reference")):
        refs = [_reference_sparse(data[r], 0.1) for r in range(RANKS)]
        ref_mean = np.sum([s for _, s in refs], axis=0) / RANKS  # psum, then / P
        out[name] = _all(
            [_check(comp[r][key]["idx"] == refs[r][0], f"rank {r}: same top-k indices")
             for r in range(RANKS)]
            + [_compare(comp[r][key]["reduced"].numpy(), ref_mean, dict(rtol=0, atol=1e-6))
               for r in range(RANKS)])
    tree = [c["tree"] for c in comp]
    out["compression_tree_and_tiny_leaf"] = _all(
        [_compare(t["reduced"]["b"]["tiny"].numpy(), tiny_all.mean(axis=0),
                  dict(rtol=1e-5, atol=1e-6)) for t in tree]
        + [_check(not t["err"]["b"]["tiny"].numpy().any(), "tiny leaf: zero residual")
           for t in tree]
        + [_compare(t["reduced"]["a"]["w"].numpy(), c["real_0.1"]["reduced"].numpy(),
                    dict(rtol=0, atol=0)) for t, c in zip(tree, comp)])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    jcfg = jfno.FNOConfig(**CFG)
    params = jax.device_get(jfno.init_params(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).standard_normal((BATCH, 1) + CFG["grid"]).astype(np.float32)
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_pipeline, RANKS, str(root), args=(params, x, CFG),
                             deadline_s=TIMEOUT_S, device="cpu")

    y_ser = np.asarray(jax.jit(lambda p, x: jfno.fno_forward(p, x, jcfg))(params, x))
    g_ser = jax.device_get(jax.jit(jax.grad(
        lambda p: jnp.mean(jfno.fno_forward(p, x, jcfg) ** 2)))(params))
    out = {}
    ys = [r["forward"]["y"].numpy() for r in ranks]
    out["forward_vs_jax_serial"] = _compare(ys[0], y_ser, FWD_TOL)
    out["forward_replicated_on_every_rank"] = _all(
        [_compare(y, ys[0], dict(rtol=0, atol=0)) for y in ys])
    n_micro = rank_side.N_MICRO
    out["forward_calls_per_stage"] = _all(
        [_check(r["forward"]["calls"] == {"fused": n_micro, "dw": 0},
                f"rank {i}: {r['forward']['calls']}") for i, r in enumerate(ranks)])
    traces = []
    for s, r in enumerate(ranks):
        ticks = [t for t in r["forward"]["trace"] if "tick" in t]
        micro = [t["micro"] for t in ticks]
        want = [t - s if 0 <= t - s < n_micro else None for t in range(n_micro + RANKS - 1)]
        traces.append(_check(micro == want and "wall_s" in r["forward"]["trace"][-1],
                             f"stage {s}: micro-batches by tick {micro}"))
    out["forward_trace_has_the_bubble"] = _all(traces)

    failed, worst = [], 0.0
    got = ranks[0]["backward"]["grads"]
    for group, leaves in g_ser.items():
        for name, ref in leaves.items():
            ref = np.conj(np.asarray(ref))  # JAX's cotangent -> torch's .grad
            scale = float(np.abs(ref).max())
            tol = dict(GRAD_TOL, atol=min(GRAD_TOL["atol"], LEAF_ATOL * scale))
            r = _compare(got[group][name].numpy(), ref, tol)
            if r["ok"]:
                worst = max(worst, float(np.abs(got[group][name].numpy() - ref).max()))
            else:
                failed.append(f"{group}.{name} (max|ref|={scale:.3e}): {r['detail']}")
    out["grads_vs_jax_serial"] = {"ok": not failed,
                                  "detail": "\n".join(failed) or f"max|d|={worst:.3e}"}
    out["backward_calls_per_stage"] = _all(
        [_check(r["backward"]["calls"] == {"fused": 3 * n_micro, "dw": n_micro},
                f"rank {i}: {r['backward']['calls']}") for i, r in enumerate(ranks)])
    losses = [r["backward"]["loss"] for r in ranks]
    out["loss_equal_on_every_rank"] = _check(len(set(losses)) == 1, f"losses {losses}")
    ref_words = {"n_blocks": "pipeline needs n_blocks == stages (2 != 4)",
                 "batch": f"{(BATCH, 3)}", "group": "stage group is None"}
    for name, check in (("n_blocks", "refuses_n_blocks_not_stages"),
                        ("batch", "refuses_batch_not_divisible"), ("group", "refuses_no_group")):
        out[check] = _all([_check(ref_words[name] in r["refusals"][name], r["refusals"][name])
                           for r in ranks])
    out.update(_compression_checks(ranks))
    path = root / "checks.json"
    path.write_text(json.dumps(out, indent=1))
    return path


@pytest.mark.parametrize("check", CHECKS)
def test_pipeline_and_compression_check(results, check):
    entry = json.loads(results.read_text()).get(check)
    assert entry is not None, f"{check} was not run"
    assert entry["ok"], entry["detail"]


@pytest.mark.parametrize("p,n_micro", [(2, 1), (4, 2), (4, 8), (8, 3)])
def test_bubble_efficiency_is_the_reference(p, n_micro):
    assert bubble_efficiency(p, n_micro) == jax_bubble_efficiency(p, n_micro)


@pytest.mark.parametrize("n,itemsize,p,ratio", [(256, 4, 8, 0.01), (393_216_000, 8, 4, 0.01),
                                                (393_216_000, 8, 4, 1.0), (10, 4, 2, 0.001)])
def test_wire_bytes_are_the_reference(n, itemsize, p, ratio):
    assert tcomp.wire_bytes_dense(n, itemsize, p) == jcomp.wire_bytes_dense(n, itemsize, p)
    assert (tcomp.wire_bytes_compressed(n, itemsize, p, ratio)
            == jcomp.wire_bytes_compressed(n, itemsize, p, ratio))
