"""The port's whisper over (data x model) ranks against the JAX package and
the port's own serial path, on the CPU.

One launch of 4 gloo ranks runs ``tests/torch_dist_whisper_checks.py``
(its docstring lists the checks) for reduced whisper-tiny (4 heads over 2
kv heads) and a narrow config that keeps whisper-tiny's 6 heads = 6 kv
heads, so that P = 4 pads them to 8 as at full width; the weights are the
JAX reference's (``init_whisper_params``), the inputs numpy draws from a
seed. This process holds what the ranks returned:

* ``whisper_loss`` on (1 x 4) and (2 x 2), ``seq_shard`` on and off: the
  loss within 1e-4 of the reference's ``whisper_loss`` under ``LOCAL``
  and of the port's serial one; every gradient leaf (reduced by
  ``reduce_grads``'s LM rule, gathered) against ``jax.value_and_grad`` of
  the reference at rtol 5e-3 with an atol of 1e-3 of the leaf's max|ref|
  (a key bias's, whose exact gradient is zero, of its layer's query
  bias's), none all zero; ``encode``'s output within 1e-4 of max|ref| of the
  reference's;
* a run with the cross-attention's sum over the group cut, and one with
  the LayerNorms' ``copy_to`` cut, each refused by those gates;
* the reference's own ``whisper_loss`` under a mesh policy (a JAX
  subprocess on 4 host devices, (1 x 4) seq_shard and (2 x 2)) against
  its ``LOCAL`` one at the same gates, and against the port's;
* ``whisper_prefill`` + greedy ``whisper_decode_step`` on (1 x 4)
  ``seq_shard``, (2 x 2) and (4 x 1) against the port's serial path (held
  to the reference in ``tests/test_torch_whisper.py``), f32 caches on
  both sides (bf16 ones would turn rounding differences of the sums over
  the group into bf16 rounding flips): tokens equal,
  logits within 1e-5 of max|ref|; each rank's cache of one shape, its
  bytes exactly its rows' and padded heads', its heads the serial cache's
  (padding heads zero); a decode step on unpicked shards equal to one on
  ``serving_heads``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_whisper_checks as rank_side
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import whisper as jwhisper
from repro.models.policy import LOCAL as JLOCAL
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import LOCAL, whisper_loss, whisper_params_from_numpy
from repro_torch.models import whisper as twhisper
from repro_torch.models.attention import padded_heads
from repro_torch.train.train_loop import accumulate_grads, zeros_like_tree
from test_torch_dist_lm import GRAD_ATOL_OF_MAX, GRAD_RTOL, _grad_close, _leaves, _np
from torch_dist_checks import one_launch_at_a_time

TIMEOUT_S = 240
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
F32 = 1e-4      # of max|ref|: the reference's serial gate
SERVE = 1e-5    # served logits over the ranks against the serial port's


def _jcfg(name):
    cfg = dataclasses.replace(jreduced(jget_arch("whisper-tiny")), dtype="float32")
    if name == "narrow":
        cfg = dataclasses.replace(cfg, d_model=96, n_heads=6, kv_heads=6, d_ff=192)
    return cfg


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    for i, name in enumerate(("reduced", "narrow")):
        jcfg = _jcfg(name)
        inp[f"params_{name}"] = jax.device_get(
            jwhisper.init_whisper_params(jax.random.PRNGKey(40 + i), jcfg))
        toks = rng.integers(1, jcfg.vocab, size=(rank_side.BATCH, rank_side.SEQ + 1))
        inp[f"{name}_tokens"] = toks[:, :-1].astype(np.int32)
        inp[f"{name}_targets"] = toks[:, 1:].astype(np.int32)
        inp[f"{name}_frames"] = rng.standard_normal(
            (rank_side.BATCH, jcfg.encoder.frames, jcfg.d_model)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_whisper")
    inp = _inputs()
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_checks, 4, str(root), args=(inp,),
                             deadline_s=TIMEOUT_S, device="cpu")
    return {"inp": inp, "ranks": ranks, "ref": {}}


def _batch(inp, name, lib):
    return {k: lib(inp[f"{name}_{k}"]) for k in ("frames", "tokens", "targets")}


def _reference(run, name):
    """(loss, gradients, encode's output) of the reference under
    ``LOCAL``, and (loss, gradients) of the port's serial path."""
    if name not in run["ref"]:
        inp, jcfg = run["inp"], _jcfg(name)
        params = jax.tree.map(jnp.asarray, inp[f"params_{name}"])
        batch = _batch(inp, name, jnp.asarray)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jwhisper.whisper_loss(p, batch, jcfg, JLOCAL), has_aux=True))(params)
        enc = jwhisper.encode(params, batch["frames"], jcfg, JLOCAL)
        cfg = rank_side.whisper_cfg(name)
        tparams = whisper_params_from_numpy(inp[f"params_{name}"], device="cpu")
        tbatch = {k: torch.from_numpy(np.asarray(v))
                  for k, v in _batch(inp, name, np.asarray).items()}
        tbatch["tokens"], tbatch["targets"] = tbatch["tokens"].long(), tbatch["targets"].long()
        tgrads = zeros_like_tree(tparams)
        tloss, _ = accumulate_grads(lambda p, b: whisper_loss(p, b, cfg), tparams, tbatch, tgrads)
        run["ref"][name] = (float(loss), jax.device_get(grads), np.asarray(enc), float(tloss),
                            tgrads)
    return run["ref"][name]


def _whisper_grad_close(got, ref, what):
    """``_grad_close`` on every leaf but the key biases. A key bias shifts
    every logit of a query by the same q . bk, which the softmax cancels:
    its exact gradient is zero and both sides' are rounding noise, held at
    the gradient gate with the scale of the same layer's query bias's
    gradient (``tests/lm_train_common.py``'s rule)."""
    got_l, ref_l = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(got_l) == sorted(ref_l), what
    for name in got_l:
        if not name.endswith(".bk"):
            continue
        g, r = _np(got_l[name]), _np(ref_l[name])
        scale = float(np.abs(_np(ref_l[name[:-2] + "bq"])).max())
        assert np.abs(g).max() > 0, f"{what}{name}: all zeros"
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * scale,
                                   err_msg=f"{what}{name}")
    _grad_close(_drop_bk(got), _drop_bk(ref), what)


def _drop_bk(tree):
    if isinstance(tree, dict):
        return {k: _drop_bk(v) for k, v in tree.items() if k != "bk"}
    return tree


@pytest.mark.parametrize("name,layout,sp", rank_side.LOSS_RUNS,
                         ids=[f"{n}-{lay}-{'seq' if sp else 'noseq'}"
                              for n, lay, sp in rank_side.LOSS_RUNS])
def test_dist_whisper_loss_matches_local(run, name, layout, sp):
    """``whisper_loss`` over the ranks against the reference's and the
    serial port's on the whole batch: the loss, every gradient leaf, and
    ``encode``'s output."""
    got = run["ranks"][0]["loss"][name, layout, sp]
    jloss, jgrads, jenc, tloss, tgrads = _reference(run, name)
    np.testing.assert_allclose(got["loss"], jloss, rtol=F32)
    np.testing.assert_allclose(got["loss"], tloss, rtol=F32)
    _whisper_grad_close(got["grads"], jgrads, f"{name} {layout} sp={sp} d")
    _whisper_grad_close(got["grads"], tgrads, f"{name} {layout} sp={sp} (serial port) d")
    enc = _np(got["encode"])
    np.testing.assert_allclose(enc, jenc, rtol=0, atol=F32 * float(np.abs(jenc).max()))


@pytest.mark.parametrize("what", list(rank_side.CUT_RUNS))
def test_dist_whisper_gate_refuses_a_cut_sum(run, what):
    """The cross-attention's row-parallel output not summed over the group
    changes the loss, which the gate refuses; the LayerNorms on a rank's
    slice of the sequence without ``copy_to`` keep the loss and leave each
    norm's gradient a rank's part, which the gradient gate refuses."""
    name = rank_side.CUT_RUNS[what][0]
    got = run["ranks"][0]["cut"][what]
    jloss, jgrads, _, _, _ = _reference(run, name)
    if what == "cross":
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got["loss"], jloss, rtol=F32)
        return
    np.testing.assert_allclose(got["loss"], jloss, rtol=F32)
    with pytest.raises(AssertionError, match=r"\.ln[123]\.|final_ln"):
        _whisper_grad_close(got["grads"], jgrads, f"{name} cut layernorm d")


_JAX_MESH_WHISPER = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduced
from repro.core.partition import make_mesh
from repro.models import whisper as wh
from repro.models.policy import ParallelPolicy
d = dict(np.load(sys.argv[2]))
cfg = dataclasses.replace(reduced(get_arch("whisper-tiny")), dtype="float32", d_model=96,
                          n_heads=6, kv_heads=6, d_ff=192)
params = {}
for key, v in d.items():
    if key.startswith("p/"):
        *path, leaf = key[2:].split("/")
        node = params
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
batch = {k: jnp.asarray(d[k]) for k in ("frames", "tokens", "targets")}
out = {}
for tag, shape, sp in (("1x4-seq", (1, 4), True), ("2x2", (2, 2), False)):
    pol = ParallelPolicy(mesh=make_mesh(shape, ("data", "model")), dp_axes=("data",),
                         model_axis="model", seq_shard=sp)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: wh.whisper_loss(p, batch, cfg, pol)[0]))(params)
    out[tag + "/loss"] = np.asarray(loss)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[tag + "/g/" + "/".join(k.key for k in path)] = np.asarray(g)
np.savez(sys.argv[3], **out)
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("tag", ["1x4-seq", "2x2"])
def test_reference_mesh_whisper_loss_equals_its_local_one(run, tag, tmp_path_factory):
    """The reference's own ``whisper_loss`` under a mesh policy, never run
    on the CPU before: on (1 x 4) seq_shard and (2 x 2) meshes of 4 host
    devices (a JAX subprocess), the narrow config's loss and every
    gradient leaf against its ``LOCAL`` ones at the same gates, and the
    loss against the port's run over the ranks on that layout."""
    if "ref_mesh" not in run["ref"]:
        inp, tmp = run["inp"], tmp_path_factory.mktemp("jax_mesh_whisper")
        src, out = str(tmp / "in.npz"), str(tmp / "out.npz")
        np.savez(src, **{"p/" + k: v for k, v in _flat(inp["params_narrow"]).items()},
                 **{k: inp[f"narrow_{k}"] for k in ("frames", "tokens", "targets")})
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", _JAX_MESH_WHISPER, SRC, src, out], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        run["ref"]["ref_mesh"] = dict(np.load(out))
    got = run["ref"]["ref_mesh"]
    jloss, jgrads, _, _, _ = _reference(run, "narrow")
    np.testing.assert_allclose(float(got[f"{tag}/loss"]), jloss, rtol=F32)
    grads = _nest({k[len(tag) + 3:]: v for k, v in got.items() if k.startswith(f"{tag}/g/")})
    _whisper_grad_close(grads, jgrads, f"reference {tag} d")
    layout, sp = ("1x4", True) if tag == "1x4-seq" else ("2x2", False)
    np.testing.assert_allclose(run["ranks"][0]["loss"]["narrow", layout, sp]["loss"],
                               float(got[f"{tag}/loss"]), rtol=F32)


def _serial_serve(run, name):
    key = ("serve", name)
    if key not in run["ref"]:
        inp, cfg = run["inp"], rank_side.whisper_cfg(name)
        params = whisper_params_from_numpy(inp[f"params_{name}"], device="cpu")
        frames = torch.from_numpy(inp[f"{name}_frames"])
        prompt = torch.from_numpy(inp[f"{name}_tokens"][:, :rank_side.PROMPT]).long()
        with torch.no_grad():
            run["ref"][key] = rank_side._greedy(params, frames, prompt, cfg, LOCAL)
    return run["ref"][key]


@pytest.mark.parametrize("name,layout", rank_side.SERVE_RUNS,
                         ids=[f"{n}-{lay}" for n, lay in rank_side.SERVE_RUNS])
def test_dist_whisper_serving_matches_the_serial_path(run, name, layout):
    """Prefill and greedy decode over the ranks: the tokens and every
    step's logits of every row against the serial port's."""
    got = run["ranks"][0]["serve"][name, layout]
    logits, toks, _ = _serial_serve(run, name)
    assert torch.equal(got["tokens"], toks)
    np.testing.assert_allclose(_np(got["logits"]), _np(logits), rtol=0,
                               atol=SERVE * float(logits.abs().max()))


@pytest.mark.parametrize("name,layout", rank_side.SERVE_RUNS,
                         ids=[f"{n}-{lay}" for n, lay in rank_side.SERVE_RUNS])
def test_each_rank_holds_its_rows_and_heads_of_the_cache(run, name, layout):
    """Every rank's cache has one shape: its data rank's rows, the kv heads
    its attention takes (whisper-tiny's 6 heads padded to 2 a rank at
    P = 4, rank 3's all padding), ``max_len`` and 12 frames; its bytes
    exactly those (f32 caches); its heads the serial cache's (within 1e-5
    of max|ref|: the steps' k/v carry the group's sums), its padding heads
    exactly zero; a step on unpicked shards is the picked one's."""
    cfg = rank_side.whisper_cfg(name)
    p = rank_side.LAYOUTS[layout]
    rows = rank_side.BATCH // (4 // p)
    n_kv = (padded_heads(cfg.n_heads, p) // p if cfg.kv_heads == cfg.n_heads
            else max(1, cfg.kv_heads * (cfg.n_heads // p) // cfg.n_heads))
    max_len = rank_side.PROMPT + rank_side.STEPS
    shapes = [(cfg.n_layers, rows, n_kv, s, cfg.head_dim_)
              for s in (max_len, max_len, cfg.encoder.frames, cfg.encoder.frames)]
    want_bytes = 4 * sum(int(np.prod(s)) for s in shapes)  # f32
    runs = [r["serve"][name, layout] for r in run["ranks"]]
    assert [r["shapes"] for r in runs] == [shapes] * 4
    assert [r["cache_bytes"] for r in runs] == [want_bytes] * 4
    assert [r["n_kv"] for r in runs] == [twhisper.cache_heads(cfg, _policy_of(p))] * 4
    assert max(r["head_rel"] for r in runs) <= SERVE
    assert max(r["pad_max"] for r in runs) == 0.0
    assert max(r["unpicked_d"] for r in runs) == 0.0
    if name == "narrow" and p == 4:
        assert [r["real_kv"] for r in runs] == [2, 2, 2, 0]


def _policy_of(p):
    from lm_train_common import StandInGroup
    from repro_torch.models import ParallelPolicy

    return ParallelPolicy(mesh={"data": StandInGroup(4 // p), "model": StandInGroup(p)})
