"""The port's SSM and hybrid families over (data x model) ranks against the
JAX package and the port's own serial engine, on the CPU.

One launch of 4 gloo ranks runs ``tests/torch_dist_recurrent_checks.py``
(its docstring lists the checks); this process holds what the ranks
returned:

* ``lm_loss`` of reduced mamba2-370m (its SSD mixer tensor-parallel over
  its heads, the gated norm's statistic summed over the group) and reduced
  recurrentgemma-2b at 4 layers (the RG-LRU mixer replicated, the local
  attention and MLPs tensor-parallel, a tail layer) on (1 x 4) and
  (2 x 2), ``seq_shard`` on and off, against ``jax.value_and_grad`` of the
  reference's ``lm_loss`` under ``LOCAL``, at the gates of
  ``test_torch_dist_lm.py``: the loss at rtol 3e-3, every leaf at rtol
  5e-3 with an atol of 1e-3 of its max|ref|, no leaf all zero; the same
  gate refusing a run with w_B's sum over the group cut and one with the
  gated norm's statistic through ``reduce_from``;
* the local attention's decode over the group (its ring by sequence, or
  by kv heads), several steps across the ring's wrap, against the
  reference's serial ``attn_decode``, and the SSD decode over the group
  against the reference's ``ssm_decode``: outputs at 1e-4 of max|ref|;
* ``Engine(policy=)`` on (1 x 4) ``seq_shard``, (2 x 2) and (4 x 1) against
  the port's serial ``Engine`` (itself held against the reference's in
  ``tests/test_torch_ssm.py`` and ``tests/test_torch_hybrid.py``): f32
  tokens equal, logits within 1e-4 of max|ref|, prompts past the reduced
  window and one decoding across its wrap; each rank holding its part of
  the cache (the SSM state by heads, the ring by sequence, the RG-LRU's
  cache whole).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_recurrent_checks as rank_side
from lm_train_common import _lm_tree
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.policy import LOCAL as JLOCAL
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import LOCAL, lm_params_from_numpy
from repro_torch.models import transformer as ttf
from test_torch_dist_lm import LOSS_RTOL, _grad_close, _np
from torch_dist_checks import one_launch_at_a_time

TIMEOUT_S = 240
F32 = 1e-4          # of max|ref|: the reference's serial gate
LM_BATCH, LM_SEQ = 4, 32
RING_BATCH = len(rank_side.RING_START)


def _jcfg(arch):
    cfg = dataclasses.replace(jreduced(jget_arch(arch)), dtype="float32")
    return dataclasses.replace(cfg, n_layers=4) if cfg.family == "hybrid" else cfg


def _close(got, ref, tol, what=""):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=tol * float(np.abs(ref).max()),
                               err_msg=what)


def _inputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, size=(LM_BATCH, LM_SEQ + 1)).astype(np.int32)
    inp = {"lm_tokens": toks[:, :-1], "lm_targets": toks[:, 1:]}
    for i, arch in enumerate(rank_side.ARCHS):
        inp[f"lm_params_{arch}"] = _lm_tree(_jcfg(arch), 30 + i)
    rcfg = _jcfg("recurrentgemma-2b")
    ring = min(rank_side.MAX_LEN, rcfg.window)
    for kvh in {kvh for _, kvh in rank_side.RING_RUNS.values()}:
        jcfg = dataclasses.replace(rcfg, kv_heads=kvh)
        inp[f"ring_params_{kvh}"] = {k: np.array(v) for k, v in jax.device_get(
            jattn.init_attn_params(jax.random.PRNGKey(kvh), jcfg)).items()}
        for n in ("k", "v"):
            inp[f"ring_{n}_{kvh}"] = rng.standard_normal(
                (RING_BATCH, kvh, ring, rcfg.head_dim_)).astype(np.float32)
    inp["ring_x"] = rng.standard_normal(
        (rank_side.RING_STEPS, RING_BATCH, 1, rcfg.d_model)).astype(np.float32)
    scfg = _jcfg("mamba2-370m")
    mixer = inp["lm_params_mamba2-370m"]["layers"]["mixer"]
    inp["ssm_params"] = {k: np.ascontiguousarray(v[0]) for k, v in mixer.items()}
    b, ssm = RING_BATCH, scfg.ssm
    inp["ssm_conv"] = rng.standard_normal(
        (b, ssm.conv_kernel, ssm.conv_dim(scfg.d_model))).astype(np.float32)
    inp["ssm_state"] = 0.5 * rng.standard_normal(
        (b, ssm.n_heads(scfg.d_model), ssm.d_state, ssm.head_dim)).astype(np.float32)
    inp["ssm_x"] = rng.standard_normal(
        (rank_side.SSM_STEPS, b, 1, scfg.d_model)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_recurrent")
    inp = _inputs()
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_checks, 4, str(root), args=(inp,),
                             deadline_s=TIMEOUT_S, device="cpu")
    serial = {arch: rank_side.serve(rank_side.lm_cfg(arch),
                                    lm_params_from_numpy(inp[f"lm_params_{arch}"], device="cpu"),
                                    LOCAL)
              for arch in rank_side.ARCHS}
    return {"inp": inp, "ranks": ranks, "serial": serial, "jax_lm": {}}


def _jax_lm(run, arch):
    """([loss, xent, aux], gradients) of the reference's ``lm_loss`` under
    ``LOCAL`` on the whole batch, once per arch."""
    if arch not in run["jax_lm"]:
        jcfg = _jcfg(arch)
        batch = {k: jnp.asarray(run["inp"][f"lm_{k}"]) for k in ("tokens", "targets")}
        (loss, m), grads = jax.jit(jax.value_and_grad(
            lambda p: jtf.lm_loss(p, batch, jcfg, JLOCAL), has_aux=True))(
            jax.tree.map(jnp.asarray, run["inp"][f"lm_params_{arch}"]))
        run["jax_lm"][arch] = ([float(loss), float(m["xent"]), float(m["aux"])],
                               jax.device_get(grads))
    return run["jax_lm"][arch]


@pytest.mark.parametrize("arch,layout,sp", rank_side.LM_RUNS,
                         ids=[f"{a}-{lay}-{'seq' if sp else 'noseq'}"
                              for a, lay, sp in rank_side.LM_RUNS])
def test_dist_recurrent_lm_loss_matches_local(run, arch, layout, sp):
    """``lm_loss`` over the ranks (this rank's rows and shards; the
    gradients reduced by ``reduce_grads``'s LM rule and gathered) against
    ``jax.value_and_grad`` of the reference's ``lm_loss`` under ``LOCAL``
    on the whole batch: the loss and its cross-entropy, every leaf (the
    SSM's whole leaves, summed over the group by ``copy_to``; the RG-LRU's,
    whole on every rank with no sum)."""
    got = run["ranks"][0]["lm"][arch, layout, sp]
    want, grads = _jax_lm(run, arch)
    np.testing.assert_allclose(_np(got["loss"])[:2], want[:2], rtol=LOSS_RTOL)
    _grad_close(got["grads"], grads, f"{arch} {layout} sp={sp} d")


@pytest.mark.parametrize("what", list(rank_side.CUT_RUNS))
def test_dist_recurrent_gate_refuses_a_cut_sum(run, what):
    """mamba2 with w_B used on each rank's heads but not entering through
    ``copy_to`` (its gradient a rank's part), or with the gated norm's
    statistic summed by ``reduce_from`` (the forward the same, the other
    ranks' cotangents of it dropped): the loss is the reference's, and the
    gradient gate refuses the run: w_B itself in the first; in the second
    the mixer's leaves upstream of the norm, while the last layer's norm_w
    and out_proj, whose gradients read the forward's values and the
    cotangent from above the mixer only, still pass."""
    got = run["ranks"][0]["cut"][what]
    want, grads = _jax_lm(run, "mamba2-370m")
    np.testing.assert_allclose(_np(got["loss"])[:2], want[:2], rtol=LOSS_RTOL)
    if what == "w_B":
        with pytest.raises(AssertionError, match=r"\.mixer\.w_B"):
            _grad_close(got["grads"], grads, "mamba2 cut w_B d")
        return
    mixer, ref = got["grads"]["layers"]["mixer"], grads["layers"]["mixer"]
    after = ("norm_w", "out_proj")
    _grad_close({k: mixer[k][-1] for k in after}, {k: ref[k][-1] for k in after},
                "mamba2 cut stat, last layer, d")
    with pytest.raises(AssertionError, match="mamba2 cut stat d"):
        _grad_close({k: v for k, v in mixer.items() if k not in after},
                    {k: v for k, v in ref.items() if k not in after}, "mamba2 cut stat d")


def _jax_ring(inp, kvh):
    """The reference's serial ``attn_decode`` of each row alone (its
    scalar index), step by step on the whole ring: [steps, b, 1, d] and
    the final ring."""
    jcfg = dataclasses.replace(_jcfg("recurrentgemma-2b"), kv_heads=kvh)
    p = jax.tree.map(jnp.asarray, inp[f"ring_params_{kvh}"])
    step = jax.jit(lambda p, x, c, i: jattn.attn_decode(p, x, c, i, jcfg))
    outs, rings = [], {"k": [], "v": []}
    for r, start in enumerate(rank_side.RING_START):
        cache = {n: jnp.asarray(inp[f"ring_{n}_{kvh}"][r:r + 1]) for n in ("k", "v")}
        row = []
        for t in range(rank_side.RING_STEPS):
            out, cache = step(p, jnp.asarray(inp["ring_x"][t, r:r + 1]), cache, start + t)
            row.append(np.asarray(out))
        outs.append(np.stack(row))
        for n in rings:
            rings[n].append(np.asarray(cache[n]))
    return np.concatenate(outs, axis=1), {n: np.concatenate(c) for n, c in rings.items()}


@pytest.mark.parametrize("name", list(rank_side.RING_RUNS))
def test_ring_decode_over_the_group_matches_the_reference(run, name):
    """The local attention's decode step over the model group, its ring of
    16 slots sharded by sequence (rank m its slots m S/P ..; every rank
    every head, the chunks' softmax combined) or by kv heads, rows starting
    before, near and past the wrap, 6 steps (row 0 across it): each step's
    output within 1e-4 of max|ref| of the reference's serial
    ``attn_decode``, and the ring the steps leave, put back together."""
    _, kvh = rank_side.RING_RUNS[name]
    ring = min(rank_side.MAX_LEN, _jcfg("recurrentgemma-2b").window)
    first = rank_side.RING_START[0]
    assert first < ring <= first + rank_side.RING_STEPS - 1 and rank_side.RING_START[2] >= ring
    got = run["ranks"][0]["ring"][name]
    want, rings = _jax_ring(run["inp"], kvh)
    _close(got["out"], want, F32, name)
    for n in ("k", "v"):
        _close(got["ring"][n], rings[n], 1e-6, f"{name} ring {n}")


@pytest.mark.parametrize("layout", ["1x4", "2x2"])
def test_ssm_decode_over_the_group_matches_the_reference(run, layout):
    """The SSD decode step over the model group (each rank its heads'
    columns and state, w_B/w_C/w_dt whole, the gated norm's statistic
    summed over the group, out_proj's rows summed), 4 steps from a random
    state and conv cache: each step's output within 1e-4 of max|ref| of
    the reference's ``ssm_decode``; the state put back together and the
    whole conv cache the same way."""
    inp = run["inp"]
    jcfg = _jcfg("mamba2-370m")
    p = jax.tree.map(jnp.asarray, inp["ssm_params"])
    cache = {"conv": jnp.asarray(inp["ssm_conv"]), "state": jnp.asarray(inp["ssm_state"])}
    step = jax.jit(lambda p, x, c: jssm.ssm_decode(p, x, c, jcfg.d_model, jcfg.ssm))
    outs = []
    for t in range(rank_side.SSM_STEPS):
        out, cache = step(p, jnp.asarray(inp["ssm_x"][t]), cache)
        outs.append(np.asarray(out))
    got = run["ranks"][0]["ssm_decode"][layout]
    _close(got["out"], np.stack(outs), F32, layout)
    _close(got["state"], cache["state"], F32, f"{layout} state")
    _close(got["conv"], cache["conv"], 1e-6, f"{layout} conv")


@pytest.mark.parametrize("arch,layout", rank_side.ENGINE_RUNS,
                         ids=[f"{a}-{lay}" for a, lay in rank_side.ENGINE_RUNS])
def test_engine_over_the_mesh_matches_the_serial_engine(run, arch, layout):
    """``Engine(policy=)`` serving 6 requests on 4 slots (prompts of 20 and
    24 past the reduced window of 16, one of 10 decoding 12 tokens across
    the ring's wrap) against the port's serial ``Engine`` on the same
    parameters, f32 caches: greedy tokens equal on every rank, every
    prefill's and decode step's logits within 1e-4 of max|ref|, no flush
    (no cache of these families has a tail)."""
    window = rank_side.lm_cfg("recurrentgemma-2b").window
    assert any(n > window for n, _ in rank_side.REQUESTS)
    assert any(n < window < n + m - 1 for n, m in rank_side.REQUESTS)
    key = (arch, layout)
    want = run["serial"][arch]
    got = run["ranks"][0]["engine"][key]
    assert all(r["engine"][key]["tokens"] == want["tokens"] for r in run["ranks"])
    assert all(r["engine"][key]["flushes"] == 0 for r in run["ranks"])
    assert got["active"] == want["active"]
    prefilled = {}
    for r in run["ranks"]:
        prefilled.update(r["engine"][key]["prefill"])
    assert sorted(prefilled) == sorted(want["prefill"])
    for rid, logits in prefilled.items():
        _close(logits, want["prefill"][rid], F32, f"prefill {rid}")
    assert len(got["decode"]) == len(want["decode"])
    for i, (g, w, active) in enumerate(zip(got["decode"], want["decode"], want["active"])):
        _close(g[active], w[active], F32, f"decode step {i}")


# the dims of each cache leaf past its stacked layer dim and its rows
_LEAF_DIMS = {"conv": 3, "h": 2, "state": 4, "k": 4, "v": 4}


@pytest.mark.parametrize("layout", list(rank_side.LAYOUTS))
def test_each_rank_holds_its_part_of_the_cache(run, layout):
    """A rank's cache holds its data rank's 1/D of the slots and: the SSM
    state's H/P heads, the local attention's ring S/P slots (its one kv
    head: by sequence), the SSM conv cache and the RG-LRU's conv and h
    whole (the port's layout; ``test_torch_dist_serve_lm.py`` names its
    difference from the reference's specs)."""
    p = rank_side.LAYOUTS[layout]
    d = 4 // p
    for arch in rank_side.ARCHS:
        cfg = rank_side.lm_cfg(arch)
        whole = [(n, tuple(t.shape)) for n, t in ttf._leaves(
            ttf.init_cache(cfg, rank_side.SLOTS, rank_side.MAX_LEN, device="meta"))]
        want = []
        for name, shape in whole:
            shape, rows = list(shape), len(shape) - _LEAF_DIMS[name]
            shape[rows] //= d
            if name == "state":
                shape[rows + 1] //= p
            if name in ("k", "v"):
                shape[rows + 2] //= p
            want.append((name, tuple(shape)))
        assert {n for n, _ in whole} == ({"conv", "state"} if cfg.family == "ssm"
                                         else {"conv", "h", "k", "v"})
        for r, rank in enumerate(run["ranks"]):
            assert rank["engine"][arch, layout]["shapes"] == want, (arch, layout, r)
