"""The port's distributed LM against the JAX package, on the CPU.

One launch of 4 gloo ranks runs ``tests/torch_dist_lm_checks.py`` (its
docstring lists the checks); this process holds what rank 0 gathered
against the reference, each check a port of one of
``tests/distributed_checks.py:131-216``:

* ``ulysses_matches_dense``: the reference's ``_dense_attention`` on the
  whole sequence, MHA and GQA, output and gradients;
* ``head_padding_exact``: reduced qwen1.5-32b with 6 heads on 4 ranks
  against the reference's ``attn_forward`` under ``LOCAL``, and the same
  with 2 kv heads at 6 and 10 heads;
* ``moe_a2a_matches_local``: the expert-parallel ``moe_apply`` on (2 x 2)
  at ``capacity_factor=4.0`` (nothing drops) against ``LOCAL``, and at
  1.25, where each shard drops past its own capacity, against the
  reference's own distributed ``moe_apply`` on a (2, 2) mesh of 4 host
  devices (a subprocess, as ``tests/distributed_checks.py`` runs); the
  data ranks routing together on (4 x 1) against ``LOCAL`` on the whole
  batch, with drops;
* ``dist_lm_loss_matches_local``: ``lm_loss`` of reduced chatglm3-6b,
  deepseek-moe-16b and deepseek-v2-lite-16b (MLA: heads column-parallel,
  the latent's down-projection whole) on (1 x 4) and (2 x 2),
  ``seq_shard`` on and off, against ``jax.value_and_grad`` of the
  reference's ``lm_loss``, and the same gate refusing MLA's run with
  ``w_dkv``'s gradient left a rank's part;

plus one AdamW step with ZeRO-1 on (2 x 2) against the reference's
``make_train_step``, the specs of every arch against the reference's, and
``shard_params`` / ``gather_params`` bitwise. Gates, f32: outputs and
losses at the reference's rtol (2e-3/2e-4 for the MoE and attention
outputs, 3e-3 for the loss), every gradient leaf at rtol 5e-3 with an
atol of 1e-3 of that leaf's max|ref|, refusing an all-zero leaf.
"""
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_lm_checks as rank_side
from lm_train_common import StandInGroup, _lm_tree
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.ulysses import _dense_attention
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models import whisper as jwhisper
from repro.models.policy import LOCAL as JLOCAL
from repro.models.policy import ParallelPolicy as JPolicy
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, ENCDEC_IDS, get_arch, reduced
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import ParallelPolicy, init_lm_params, lm_params_to_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import param_specs
from repro_torch.models.whisper import whisper_param_specs
from torch_dist_checks import one_launch_at_a_time

TIMEOUT_S = 240
OUT_TOL = (2e-3, 2e-4)        # tests/distributed_checks.py: moe and head padding
ULYSSES_TOL = (2e-4, 2e-5)    # tests/distributed_checks.py: ulysses
LOSS_RTOL = 3e-3              # tests/distributed_checks.py: dist_lm_loss_matches_local
GRAD_RTOL, GRAD_ATOL_OF_MAX = 5e-3, 1e-3
MOE_D = 32
MOE_SHAPES = {"4.0": (2, 16), "1.25": (2, 1024), "together": (8, 128)}
LM_BATCH, LM_SEQ = 4, 32
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _leaves(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [t for i, v in enumerate(tree) for t in _leaves(v, f"{prefix}.{i}")]
    return [(prefix, tree)]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _grad_close(got, ref, what):
    """Every leaf of ``got`` at the gradient gate against ``ref`` (same
    tree), none all zeros where ``ref`` is not."""
    pairs = list(zip(_leaves(got), _leaves(ref)))
    assert pairs and len(_leaves(got)) == len(_leaves(ref)), what
    for (name, g), (_, r) in pairs:
        g, r = _np(g), _np(r)
        scale = float(np.abs(r).max())
        assert g.shape == r.shape, (what, name, g.shape, r.shape)
        assert scale == 0.0 or np.abs(g).max() > 0, f"{what}{name}: all zeros"
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * scale,
                                   err_msg=f"{what}{name}")


def _moe_cfg(cf):
    return dict(n_experts=8, top_k=2, d_expert=16, n_shared=1,
                capacity_factor=4.0 if cf == "4.0" else 1.25)


def _moe_params(seed):
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), MOE_D, jmoe.MoEConfig(**_moe_cfg("4.0")))
    return jax.device_get(p)


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    b, s, h, d = 2, 32, 8, 16
    for name, kvh in (("mha", 8), ("gqa", 2)):
        for n, heads in (("q", h), ("k", kvh), ("v", kvh), ("cot", h)):
            inp[f"{name}_{n}"] = rng.standard_normal((b, s, heads, d)).astype(np.float32)
    qcfg = _head_padding_cfg("mha")
    inp["attn"] = {"mha": _attn_params(qcfg, rng)}
    inp["x"] = rng.standard_normal((4, 32, qcfg.d_model)).astype(np.float32)
    inp["cot"] = rng.standard_normal((4, 32, qcfg.d_model)).astype(np.float32)
    for cf, (mb, ms) in MOE_SHAPES.items():
        inp[f"moe_cfg_{cf}"] = _moe_cfg("4.0" if cf == "4.0" else "1.25")
        inp[f"moe_params_{cf}"] = _moe_params(1)
        inp[f"moe_x_{cf}"] = rng.standard_normal((mb, ms, MOE_D)).astype(np.float32)
        inp[f"moe_cot_{cf}"] = rng.standard_normal((mb, ms, MOE_D)).astype(np.float32)
    toks = rng.integers(0, 512, size=(LM_BATCH, LM_SEQ + 1)).astype(np.int32)
    inp["lm_tokens"], inp["lm_targets"] = toks[:, :-1], toks[:, 1:]
    for i, arch in enumerate(rank_side.LM_ARCHS):
        inp[f"lm_params_{arch}"] = _lm_tree(_jcfg(arch), 10 + i)
    inp["roundtrip"] = {
        arch: lm_params_to_numpy(init_lm_params(reduced(get_arch(arch)),
                                                generator=torch.Generator().manual_seed(3),
                                                device="cpu"))
        for arch in ARCH_IDS if arch not in ENCDEC_IDS}
    gqa_rng = np.random.default_rng(1)
    for name in rank_side.HEAD_PADDING:
        if name != "mha":
            inp["attn"][name] = _attn_params(_head_padding_cfg(name), gqa_rng)
    return inp


def _head_padding_cfg(name):
    h, kvh = rank_side.HEAD_PADDING[name]
    return dataclasses.replace(jreduced(jget_arch("qwen1.5-32b")), n_heads=h, kv_heads=kvh,
                               dtype="float32")


def _attn_params(cfg, rng):
    """The reference's attention weights of ``cfg``, with non-zero biases,
    so that their gradients and placement are held too."""
    attn = jax.device_get(jattn.init_attn_params(jax.random.PRNGKey(0), cfg))
    return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            if k.startswith("b") else np.asarray(v) for k, v in attn.items()}


def _jcfg(arch):
    return dataclasses.replace(jreduced(jget_arch(arch)), dtype="float32")


_JAX_DIST_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, jax.numpy as jnp
from repro.core.partition import make_mesh
from repro.models.moe import MoEConfig, moe_apply
from repro.models.policy import ParallelPolicy
d = dict(np.load(sys.argv[2], allow_pickle=True))
moe = MoEConfig(**d.pop("cfg").item())
x, cot = jnp.asarray(d.pop("x")), jnp.asarray(d.pop("cot"))
params = {k: jnp.asarray(v) for k, v in d.items() if not k.startswith("shared.")}
params["shared"] = {k[7:]: jnp.asarray(v) for k, v in d.items() if k.startswith("shared.")}
pol = ParallelPolicy(mesh=make_mesh((2, 2), ("data", "model")), dp_axes=("data",),
                     model_axis="model")
def f(p, x):
    y, aux = moe_apply(p, x, moe, pol)
    return jnp.sum(y * cot) + aux, (y, aux)
(_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(params, x)
out = {"y": np.asarray(y), "aux": np.asarray(aux), "x": np.asarray(gx)}
out.update({k: np.asarray(v) for k, v in gp.items() if k != "shared"})
out.update({"shared." + k: np.asarray(v) for k, v in gp["shared"].items()})
np.savez(sys.argv[3], **out)
"""


def _jax_moe_dist(inp, tmp):
    """The reference's distributed ``moe_apply`` at capacity 1.25 on a
    (2, 2) mesh of 4 host devices, in a subprocess."""
    p = inp["moe_params_1.25"]
    arrays = {"cfg": np.array(inp["moe_cfg_1.25"], dtype=object), "x": inp["moe_x_1.25"],
              "cot": inp["moe_cot_1.25"], **{k: v for k, v in p.items() if k != "shared"},
              **{f"shared.{k}": v for k, v in p["shared"].items()}}
    src, out = os.path.join(tmp, "moe_in.npz"), os.path.join(tmp, "moe_out.npz")
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX_DIST_MOE, SRC, src, out], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


def _jax_moe_local(inp, cf):
    moe = jmoe.MoEConfig(**inp[f"moe_cfg_{cf}"])
    cot = jnp.asarray(inp[f"moe_cot_{cf}"])

    def f(p, x):
        y, aux = jmoe.moe_apply(p, x, moe, JLOCAL)
        return jnp.sum(y * cot) + aux, (y, aux)

    params = jax.tree.map(jnp.asarray, inp[f"moe_params_{cf}"])
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(inp[f"moe_x_{cf}"]))
    flat = {k: v for k, v in gp.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in gp["shared"].items()})
    return {"y": np.asarray(y), "aux": np.asarray(aux), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in flat.items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_lm")
    inp = _inputs()
    jax_dist = _jax_moe_dist(inp, str(root))
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_checks, 4, str(root), args=(inp,),
                             deadline_s=TIMEOUT_S, device="cpu")
    return {"inp": inp, "ranks": ranks, "jax_moe_dist": jax_dist, "jax_lm": {}}


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_ulysses_matches_dense(run, name):
    """``ulysses_attention`` over 4 ranks (R_{s->h}, local attention,
    R_{h->s}; the GQA branch's all-gather of 2 kv heads) against dense
    attention on the whole sequence, output and d(q, k, v)."""
    inp, got = run["inp"], run["ranks"][0]["ulysses"][name]
    q, k, v, cot = (jnp.asarray(inp[f"{name}_{n}"]) for n in ("q", "k", "v", "cot"))
    ref, vjp = jax.vjp(lambda q, k, v: _dense_attention(q, k, v, causal=True, scale=None), q, k, v)
    np.testing.assert_allclose(_np(got["out"]), np.asarray(ref), rtol=ULYSSES_TOL[0],
                               atol=ULYSSES_TOL[1])
    _grad_close(got["grads"], list(vjp(cot)), f"ulysses {name} d")


def _check_head_padding(run, name):
    """The ranks' padded attention against the reference's ``attn_forward``
    under ``LOCAL`` (unpadded): output, every weight's and bias's
    gradient, and x's."""
    inp, got = run["inp"], run["ranks"][0]["head_padding"][name]
    cfg = _head_padding_cfg(name)
    assert cfg.qkv_bias
    p = jax.tree.map(jnp.asarray, inp["attn"][name])
    ref, vjp = jax.vjp(jax.jit(lambda p, x: jattn.attn_forward(p, x, cfg, JLOCAL)), p,
                       jnp.asarray(inp["x"]))
    np.testing.assert_allclose(_np(got["out"]), np.asarray(ref), rtol=OUT_TOL[0], atol=OUT_TOL[1])
    gp, gx = vjp(jnp.asarray(inp["cot"]))
    _grad_close(got["grads"], {**gp, "x": gx}, f"head padding {name} d")


def test_head_padding_exact(run):
    """6 heads padded to 8 on 4 ranks (rank 3 holds only padded heads; the
    weights' column shards cut inside heads)."""
    _check_head_padding(run, "mha")


@pytest.mark.parametrize("name", [n for n in rank_side.HEAD_PADDING if n != "mha"])
def test_head_padding_gqa_exact(run, name):
    """2 kv heads with 6 or 10 q heads padded to 8 or 12 on 4 ranks: a
    rank whose heads are all real takes the kv heads its q heads read
    (``kv_heads_for``); a rank with padded heads (rank 3: none real of 2,
    or 1 real of 3) takes one kv head per q head. The padded GQA branch is
    the port's own (the reference's ``_pad_heads`` regroups the kv heads),
    so it is held against the unpadded reference."""
    _check_head_padding(run, name)


@pytest.mark.parametrize("case", ["moe_a2a_4.0", "moe_a2a_1.25", "moe_together"])
def test_moe_a2a_matches_local(run, case):
    """The MoE's distributed paths: at capacity 4.0 the all-to-all on
    (2 x 2) drops nothing and equals ``LOCAL``; at 1.25 each (data, model)
    shard drops past its own capacity, as the reference's distributed
    ``moe_apply`` does; on (4 x 1) the data ranks route as one batch, with
    ``LOCAL``'s global capacity and drops. y, aux and every gradient."""
    inp, got = run["inp"], run["ranks"][0][case]
    cf = case.rsplit("_", 1)[1]
    ref = run["jax_moe_dist"] if cf == "1.25" else _jax_moe_local(inp, cf)
    moe = tmoe.MoEConfig(**inp[f"moe_cfg_{cf}"])
    x = torch.from_numpy(inp[f"moe_x_{cf}"])
    if cf != "4.0":  # the capacity drops entries: the check is not vacuous
        t = x.shape[0] * x.shape[1] // (4 if cf == "1.25" else 1)
        topi, _, _ = tmoe._route(x.reshape(-1, MOE_D)[:t], torch.tensor(
            np.asarray(inp[f"moe_params_{cf}"]["router"])), moe)
        keep = tmoe._dispatch(x.reshape(-1, MOE_D)[:t], topi, tmoe._capacity(t, moe),
                              moe.n_experts)[3]
        assert not bool(keep.all())
    np.testing.assert_allclose(_np(got["y"]), ref["y"], rtol=OUT_TOL[0], atol=OUT_TOL[1])
    np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]), rtol=1e-3)
    _grad_close(got["grads"], {k: ref[k] for k in got["grads"]}, f"{case} d")


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
def test_dist_lm_loss_matches_local(run, arch, layout, sp):
    """``lm_loss`` over the ranks (this rank's rows and shards; the
    gradients reduced by ``reduce_grads``'s LM rule and gathered) against
    ``jax.value_and_grad`` of the reference's ``lm_loss`` under ``LOCAL``
    on the whole batch: the loss, its cross-entropy and aux, every leaf."""
    got = run["ranks"][0]["lm"][arch, layout, sp]
    want, grads = _jax_lm(run, arch)
    np.testing.assert_allclose(_np(got["loss"])[:2], want[:2], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["loss"][2]), want[2], rtol=LOSS_RTOL, atol=1e-7)
    _grad_close(got["grads"], grads, f"{arch} {layout} sp={sp} d")


def test_dist_lm_gate_refuses_mla_with_w_dkv_left_a_part(run):
    """The MLA run on (1 x 4) with ``w_dkv``'s ``copy_to`` cut (each rank's
    latent feeds its own heads, so its gradient of w_dkv is a part until
    the group sums it): the loss is the reference's, and the gradient gate
    refuses w_dkv."""
    arch, layout, sp = rank_side.CUT_RUN
    got = run["ranks"][0]["lm_cut"]
    want, grads = _jax_lm(run, arch)
    np.testing.assert_allclose(_np(got["loss"])[:2], want[:2], rtol=LOSS_RTOL)
    with pytest.raises(AssertionError, match="w_dkv"):
        _grad_close(got["grads"], grads, f"{arch} {layout} sp={sp} cut d")


def test_one_adamw_step_with_zero1_matches_the_reference_step(run):
    """One step of ``make_train_step`` with the LM layout on (2 x 2),
    ``seq_shard``, ZeRO-1 moments over the data group, against the
    reference's ``make_train_step`` on the whole batch: the metrics, and
    every param after the step (1e-4 relative plus 5% of lr: an entry
    whose gradient is f32 noise steps by up to lr either way)."""
    arch = rank_side.STEP_RUN[0]
    jcfg = _jcfg(arch)
    jstep = jmake_train_step(lambda p, b: jtf.lm_loss(p, b, jcfg, JLOCAL),
                             JAdamWConfig(**rank_side.OPT_KW))
    params = jax.tree.map(jnp.asarray, run["inp"][f"lm_params_{arch}"])
    batch = {k: jnp.asarray(run["inp"][f"lm_{k}"]) for k in ("tokens", "targets")}
    jp, _, jm = jax.jit(jstep)(params, jinit_opt_state(params), batch)
    got = run["ranks"][0]["step"]
    for k in ("loss", "xent", "grad_norm", "lr"):
        assert got["metrics"][k] == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-7), k
    lr = rank_side.OPT_KW["lr"]
    for (name, a), (_, b) in zip(_leaves(got["params"]), _leaves(jax.device_get(jp))):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4, atol=0.05 * lr, err_msg=name)


@pytest.mark.parametrize("layout", list(rank_side.LAYOUTS))
def test_shard_then_gather_params_is_bitwise_for_every_arch(run, layout):
    """``shard_params`` then ``gather_params`` gives back every reduced
    decoder config's tree bitwise on every rank, and each rank's shards
    have the shapes the specs cut."""
    p = rank_side.LAYOUTS[layout]
    for r, rank in enumerate(run["ranks"]):
        for (arch, lay), res in rank["roundtrip"].items():
            if lay != layout:
                continue
            assert res["bitwise"], (arch, layout, r)
            cfg = reduced(get_arch(arch))
            pol = ParallelPolicy(mesh={"data": StandInGroup(4 // p), "model": StandInGroup(p)})
            specs = param_specs(cfg, pol)
            whole = run["inp"]["roundtrip"][arch]
            want = []
            for (_, leaf), (_, spec) in zip(_leaves(whole), _spec_leaves(specs, whole)):
                shape = list(leaf.shape)
                if p > 1 and "model" in spec:
                    shape[spec.index("model")] //= p
                want.append(tuple(shape))
            assert res["shapes"] == want, (arch, layout)


def _spec_leaves(specs, like, prefix=""):
    if like is None:
        return []
    if isinstance(like, dict):
        return [t for k in sorted(like) for t in _spec_leaves(specs[k], like[k], f"{prefix}.{k}")]
    if isinstance(like, list):
        return [t for i, (s, v) in enumerate(zip(specs, like))
                for t in _spec_leaves(s, v, f"{prefix}.{i}")]
    return [(prefix, specs)]


def _as_tuples(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("model", [1, 2, 4, 16])
def test_param_specs_are_the_references_for_every_arch(model):
    """``param_specs`` (decoders, with ``moe_param_specs``) and
    ``whisper_param_specs`` equal the reference's, each PartitionSpec as
    the tuple of its entries, at model axes that divide the embedding and
    vocab or not."""
    jmesh = types.SimpleNamespace(shape={"data": 1, "model": model})
    jpol = JPolicy(mesh=jmesh)
    pol = ParallelPolicy(mesh={"data": StandInGroup(1), "model": StandInGroup(model)})
    assert set(JARCH_IDS) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        if arch in ENCDEC_IDS:
            want = jwhisper.whisper_param_specs(jget_arch(arch), jpol)
            got = whisper_param_specs(get_arch(arch))
        else:
            want = jtf.param_specs(jget_arch(arch), jpol)
            got = param_specs(get_arch(arch), pol)
        assert got == _as_tuples(want), arch
    assert tmoe.moe_param_specs(get_arch("deepseek-moe-16b").moe) == _as_tuples(
        jmoe.moe_param_specs(jget_arch("deepseek-moe-16b").moe))
