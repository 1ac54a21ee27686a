"""The port's MoE-family serving path against the JAX reference, on the CPU.

deepseek-moe-16b (fine-grained experts, a dense first layer, MHA) and
deepseek-v2-lite-16b (the same with multi-head latent attention), reduced
as the reference reduces them. Inputs are drawn with numpy and carried
across (``lm_params_from_numpy``); the reference runs with
``ParallelPolicy(use_pallas=True)``, so its RMSNorm and flash attention are
the TPU kernels in interpret mode, while the port's wrappers run their
plain versions on CPU tensors. Tolerances, stated where they are used:
routing, dispatch and combine bitwise (on integer-valued inputs, whose
products and sums are exact on both sides, so ties are exact ties); the
MoE block and MLA at f32 within 1e-5; the slice at f32 within 1e-4 of
max|ref| (prefill logits and caches, and decode logits on the same bf16
cache contents), greedy tokens identical; at bf16 within 3e-2 of max|ref|
(bf16 rounds every activation, in another order on each side).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.policy import ParallelPolicy
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve.engine import TransformerRunner as JRunner
from repro_torch.configs import MOE_IDS, get_arch, reduced
from repro_torch.models import (
    init_cache,
    init_lm_params,
    lm_decode_step,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_prefill,
)
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import norms_per_forward, serving_params
from repro_torch.serve import Engine, Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = ParallelPolicy(use_pallas=True)
F32, BF16 = 1e-4, 3e-2
NORMS = ("ln1", "ln2", "final_norm", "kv_norm")
MLA = "deepseek-v2-lite-16b"


def _cfgs(arch, dtype=None):
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    if dtype:
        jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    return jcfg, cfg


def _np_params(jcfg, seed):
    """A parameter tree of the reference's shapes drawn with numpy: fan-in
    scaled weights, norms near 1."""
    shapes = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def walk(tree, name=None):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        if name in NORMS:
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-1] if name == "embed" else shape[-2]
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    return walk(shapes)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_torch(a):
    return torch.from_numpy(np.array(_f32(a))).bfloat16()


def _close(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|d|={err:.3e} > {rel} * max|ref|={scale:.3e}"


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(np.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_IDS)
def test_moe_configs_match_the_reference(arch):
    for full in (True, False):
        jcfg = jget_arch(arch) if full else jreduced(jget_arch(arch))
        cfg = get_arch(arch) if full else reduced(get_arch(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.head_dim == jcfg.head_dim and cfg.head_dim_ == jcfg.head_dim_
        assert cfg.layer_kinds() == jcfg.layer_kinds() == ("dense0",) + ("moe",) * (cfg.n_layers - 1)
        assert cfg.approx_params() == jcfg.approx_params()
        assert cfg.approx_active_params() == jcfg.approx_active_params()
    if arch == MLA:
        assert reduced(get_arch(arch)).head_dim is None


def test_v2_lite_full_width_numbers():
    cfg = get_arch(MLA)
    m, mo = cfg.mla, cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == (27, 2048, 16, 102400)
    assert (m.kv_lora, m.dh_nope, m.dh_rope, m.dh_v) == (512, 128, 64, 128)
    assert (mo.n_experts, mo.top_k, mo.n_shared, mo.d_expert, mo.first_dense_ff) == (64, 6, 2, 1408, 10944)
    assert abs(cfg.approx_params() - 15.71e9) < 0.01e9
    assert norms_per_forward(cfg) == 3 * 27 + 1 == 82
    assert norms_per_forward(get_arch("deepseek-moe-16b")) == 2 * 28 + 1


# ---------------------------------------------------------------------------
# MoE units
# ---------------------------------------------------------------------------

def _moe_cfg(norm_topk=False, n_shared=0, top_k=2, n_experts=8):
    return (jmoe.MoEConfig(n_experts=n_experts, top_k=top_k, d_expert=16, n_shared=n_shared,
                           norm_topk=norm_topk),
            tmoe.MoEConfig(n_experts=n_experts, top_k=top_k, d_expert=16, n_shared=n_shared,
                           norm_topk=norm_topk))


@pytest.mark.parametrize("norm_topk", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_with_exact_ties(norm_topk, dtype):
    """Small integer tokens and router weights make the logits exact
    integers on both sides, so equal logits are exact ties; the reference's
    top_k keeps the lower expert first, and so must the port."""
    jm, tm = _moe_cfg(norm_topk, top_k=3)
    rng = np.random.default_rng(5 + norm_topk)
    x = rng.integers(-2, 3, size=(64, 8)).astype(np.float32)
    router = rng.integers(-1, 2, size=(8, 8)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    jtopi, jtopv, jprobs = jmoe._route(jx, jnp.asarray(router), jm)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    topi, topv, probs = tmoe._route(tx, torch.from_numpy(router), tm)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    assert topv.dtype == tx.dtype
    np.testing.assert_allclose(_f32(topv), _f32(jtopv), rtol=1e-6, atol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=0)
    # the crafted ties are there: tokens whose k-th and (k+1)-th probabilities
    # are equal, so the order among equals decides the route
    p = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    assert (p[:, 2] == p[:, 3]).sum() >= 5
    # lower index first among the tied: each token's chosen experts of equal
    # probability come in increasing index order
    jp = np.asarray(jprobs)
    for row, idx in zip(jp, topi.numpy()):
        for a, b in zip(idx[:-1], idx[1:]):
            assert row[a] > row[b] or (row[a] == row[b] and a < b)


def test_capacity_matches_over_token_counts():
    for arch in MOE_IDS:
        for full in (True, False):
            jm = (jget_arch(arch) if full else jreduced(jget_arch(arch))).moe
            tm = (get_arch(arch) if full else reduced(get_arch(arch))).moe
            for t in list(range(1, 300)) + [512, 999, 1000, 1024, 4096, 32768]:
                assert tmoe._capacity(t, tm) == jmoe._capacity(t, jm), (arch, full, t)
    # up to 128 tokens are dropless; a 1000-token prefill has room for 128
    # of its 6000 entries on each of 64 experts
    full = get_arch(MLA).moe
    assert all(tmoe._capacity(t, full) >= t for t in range(1, 129))
    assert tmoe._capacity(1000, full) == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_bitwise_with_an_overloaded_expert(dtype):
    """Expert 0 takes most entries and overflows its capacity: the same
    entries are dropped, the buffers and the combined output are bitwise
    the reference's (top-2: a sum of two terms is exact in either order)."""
    rng = np.random.default_rng(7)
    t, k, e, cap = 40, 2, 4, 6
    x = rng.integers(-4, 5, size=(t, 8)).astype(np.float32)
    topi = np.stack([np.zeros(t, np.int64), rng.integers(1, e, size=t)], axis=1)
    topi[::3] = topi[::3, ::-1]  # expert 0 second for some tokens
    topv = rng.choice([0.25, 0.5, 0.75], size=(t, k)).astype(np.float32)
    jx, jv = jnp.asarray(x, dtype), jnp.asarray(topv, dtype)
    jbuf, je, jpos, jkeep = jmoe._dispatch(jx, jnp.asarray(topi, jnp.int32), jv, cap, e)
    tx, tv = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(topv).to(getattr(torch, dtype))
    buf, e_flat, pos, keep = tmoe._dispatch(tx, torch.from_numpy(topi), cap, e)
    assert not bool(keep.all()) and int((~keep).sum()) == int((~np.asarray(jkeep)).sum())
    np.testing.assert_array_equal(_f32(buf), _f32(jbuf))
    np.testing.assert_array_equal(e_flat.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    y_np = rng.integers(-3, 4, size=(e, cap, 8)).astype(np.float32)
    jy = jmoe._combine(jnp.asarray(y_np, dtype), je, jpos, jkeep, jv, t, cap)
    y = tmoe._combine(torch.from_numpy(y_np).to(tx.dtype), e_flat, pos, keep, tv, t, cap)
    assert y.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(y), _f32(jy))


def _moe_params(jm, d, seed, hot_expert=False):
    shapes = jax.eval_shape(lambda: jmoe.init_moe_params(jax.random.PRNGKey(0), d, jm))
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        shape = tuple(tree.shape)
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)

    p = walk(shapes)
    if hot_expert:  # expert 0 wins most routes: its capacity overflows
        p["router"][:, 0] = 2.0
    return p


@pytest.mark.parametrize("n_shared,norm_topk,t,hot", [
    (0, False, 48, False), (1, True, 48, False), (2, False, 48, False), (1, True, 300, True)])
def test_moe_apply_matches_float32(n_shared, norm_topk, t, hot):
    jm, tm = _moe_cfg(norm_topk, n_shared)
    d = 16
    p = _moe_params(jm, d, 11 + n_shared, hot)
    x = np.random.default_rng(12).standard_normal((2, t // 2, d)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(_jtree(p), jnp.asarray(x), jm)
    tp = lm_params_from_numpy(p, device="cpu")
    y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tm)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the load-balance loss is the one of the routes
    topi, _, probs = tmoe._route(torch.from_numpy(x).reshape(-1, d), tp["router"], tm)
    np.testing.assert_allclose(float(tmoe._aux_loss(topi, probs, tm) * tm.aux_coef), float(jaux),
                               rtol=1e-5)
    if hot:  # the same entries were dropped on both sides
        _, _, _, keep = tmoe._dispatch(torch.from_numpy(x).reshape(-1, d), topi,
                                       tmoe._capacity(t, tm), tm.n_experts)
        assert not bool(keep.all())


@pytest.mark.parametrize("n_shared", [0, 1])
def test_dropless_moe_keeps_every_entry_past_128_tokens(n_shared):
    """The reference decodes each slot alone (one token under ``vmap``,
    capacity 1), so its decode never drops. 130 tokens that all pick
    expert 0 overflow ``_capacity(130)`` = 128; with ``dropless`` the port
    routes them as one batch and matches the reference token by token."""
    jm, tm = _moe_cfg(n_shared=n_shared)
    d, t = 16, 130
    p = _moe_params(jm, d, 31 + n_shared, hot_expert=True)
    # positive inputs: expert 0's logit 2 * sum(x) beats every other
    x = np.abs(np.random.default_rng(32).standard_normal((t, 1, d))).astype(np.float32)
    jy = jax.vmap(lambda xi: jmoe.moe_apply(_jtree(p), xi[None], jm)[0][0])(jnp.asarray(x))
    tp = lm_params_from_numpy(p, device="cpu")
    tx = torch.from_numpy(x)
    y, _ = tmoe.moe_apply(tp, tx, tm, dropless=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    topi, _, _ = tmoe._route(tx.reshape(t, d), tp["router"], tm)
    assert bool((topi == 0).any(-1).all()) and tmoe._capacity(t, tm) < t
    _, _, _, keep = tmoe._dispatch(tx.reshape(t, d), topi, tmoe._capacity(t, tm), tm.n_experts)
    assert not bool(keep.all())  # without dropless the batch would drop


def test_routed_experts_over_two_model_ranks_on_three_tokens_match(tmp_path):
    """Routed experts split over a model group whose size does not divide
    the sequence (2 ranks, 3 tokens): each rank routes the same tokens, runs
    its half of the experts, and the group sums the parts (the reference
    computes them where the tokens are, ``_moe_local``); the shared experts
    run tensor-parallel. On 2 gloo ranks against the reference's
    ``moe_apply``: y and aux within 1e-5. Larger cases, their gradients and
    decode batches: ``tests/test_torch_dist_serve_lm.py``."""
    import torch_dist_serve_lm_checks as rank_side
    from repro_torch.launch.mesh import launch_ranks
    from torch_dist_checks import one_launch_at_a_time

    jm, tm = _moe_cfg(n_shared=1)
    p = _moe_params(jm, 16, 33)
    x = np.random.default_rng(34).standard_normal((1, 3, 16)).astype(np.float32)
    want, waux = jmoe.moe_apply(_jtree(p), jnp.asarray(x), jm)
    inp = {"params": p, "x": x, "cfg": dataclasses.asdict(tm)}
    with one_launch_at_a_time():
        y, aux = launch_ranks(rank_side.moe_on_model_ranks, 2, str(tmp_path), args=(inp,),
                              deadline_s=120, device="cpu")[0]
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_layer(seed, dtype="float32"):
    jcfg, cfg = _cfgs(MLA, dtype)
    p_np = jax.tree.map(lambda a: a[0], _np_params(jcfg, seed)["layers"]["attn"])
    return jcfg, cfg, p_np, {k: torch.from_numpy(v) for k, v in p_np.items()}


def test_mla_forward_matches():
    jcfg, cfg, p_np, p = _mla_layer(60)
    x = np.random.default_rng(61).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    want = jattn.mla_forward(_jtree(p_np), jnp.asarray(x), jcfg, PALLAS)
    got, ckv, kr = tattn.mla_forward(p, torch.from_numpy(x), cfg, return_latents=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _, _, jckv, jkr = jattn._mla_qkr(_jtree(p_np), jnp.asarray(x), jcfg, jnp.arange(11))
    np.testing.assert_allclose(ckv.numpy(), np.asarray(jckv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_on_a_latent_cache_matches(dtype):
    """``init_mla_cache`` + ``mla_decode`` (one layer) vs the reference's on
    the same bf16 cache contents."""
    jcfg, cfg, p_np, p = _mla_layer(62, dtype)
    rng = np.random.default_rng(63)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    m = cfg.mla
    ckv = rng.standard_normal((2, 6, m.kv_lora)).astype(ml_dtypes.bfloat16)
    kr = rng.standard_normal((2, 6, m.dh_rope)).astype(ml_dtypes.bfloat16)
    jcache = jattn.init_mla_cache(jcfg, 2, 9)
    jcache = {"ckv": jcache["ckv"].at[:, :6].set(jnp.asarray(ckv)),
              "kr": jcache["kr"].at[:, :6].set(jnp.asarray(kr))}
    jx = jnp.asarray(x, dtype)
    want, jnew = jattn.mla_decode(_jtree(p_np), jx, jcache, jnp.int32(6), jcfg)
    cache = tattn.init_mla_cache(cfg, 2, 9, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), torch.bfloat16) for k, v in jcache.items()}
    cache["ckv"][:, :6] = _bf16_torch(ckv)
    cache["kr"][:, :6] = _bf16_torch(kr)
    got, new = tattn.mla_decode(p, torch.from_numpy(np.array(_f32(jx))).to(getattr(torch, dtype)), cache,
                                torch.tensor([6, 6]), cfg)
    assert new is cache and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        _close(got, want, BF16, "bf16 mla_decode out")
    for name in ("ckv", "kr"):
        np.testing.assert_array_equal(_f32(new[name]), _f32(jnew[name]))


@pytest.mark.parametrize("arch", MOE_IDS)
def test_cache_tree_matches_the_reference(arch):
    jcfg, cfg = _cfgs(arch)
    want = jtf.init_cache(jcfg, 3, 10)
    got = init_cache(cfg, 3, 10, device="cpu")
    assert jax.tree.structure(lm_params_to_numpy(got)) == jax.tree.structure(want)
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.bfloat16 and not g.any()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_IDS)
def test_init_lm_params_has_the_reference_tree(arch):
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    got = lm_params_to_numpy(init_lm_params(cfg, generator=torch.Generator().manual_seed(0),
                                            device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == tuple(w.shape) and g.dtype == np.float32
    tree = _np_params(jcfg, 3)  # and the reference's tree, layer0 included, round trips
    back = lm_params_to_numpy(lm_params_from_numpy(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch,dtype", [(MLA, "bfloat16"), (MLA, "float32"),
                                        ("deepseek-moe-16b", "bfloat16"), ("gemma-7b", "bfloat16"),
                                        ("chatglm3-6b", "bfloat16")])
def test_leaf_by_leaf_serving_draw_is_bitwise_the_cast_masters(arch, dtype):
    """``init_lm_params(serving=True)`` casts each leaf as it is drawn:
    bitwise ``serving_params(init_lm_params(...))`` from the same seed."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype=dtype)
    cpu = torch.device("cpu")
    want = serving_params(init_lm_params(cfg, generator=torch.Generator().manual_seed(3),
                                         device=cpu), cfg, cpu)
    got = init_lm_params(cfg, generator=torch.Generator().manual_seed(3), device=cpu, serving=True)
    assert jax.tree.structure(lm_params_to_numpy(got)) == jax.tree.structure(lm_params_to_numpy(want))
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert pairs and all(g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs)
    if arch == MLA:
        attn = got["layers"]["attn"]
        assert attn["k_up"].dtype == attn["kv_norm"].dtype == torch.float32
        assert got["layers"]["moe"]["w_gate"].dtype == cfg.activation_dtype


# ---------------------------------------------------------------------------
# the slice: prefill, decode and Engine per MoE config
# ---------------------------------------------------------------------------

def _prefill_both(jcfg, cfg, tree, tokens, max_len):
    jlogits, jcache = jax.jit(
        lambda p, t: jtf.lm_prefill(p, t, jcfg, PALLAS, max_len=max_len))(_jtree(tree), tokens)
    params = lm_params_from_numpy(tree, device="cpu")
    logits, cache = lm_prefill(params, torch.from_numpy(tokens).long(), cfg, max_len=max_len)
    return (jlogits, jcache), (logits, cache), params


def _to_port_cache(jcache):
    """The reference's cache as the port's tree of bf16 tensors."""
    return jax.tree.map(lambda a: _bf16_torch(a), jcache)


@pytest.mark.parametrize("arch", MOE_IDS)
def test_prefill_and_decode_match_float32(arch):
    jcfg, cfg = _cfgs(arch, "float32")
    tree = _np_params(jcfg, 10)
    tokens = _tokens(11, 2, 13, cfg.vocab)
    max_len, steps = 24, 4
    (jl, jc), (tl, tc), params = _prefill_both(jcfg, cfg, tree, tokens, max_len)
    _close(tl, jl, F32, "prefill logits")
    for g, w in zip(_leaves(tc), jax.tree.leaves(jc)):
        _close(g, w, F32, "prefill cache")
    # decode on the serving path's bf16 cache, from the same contents
    jcache = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jc)
    cache = _to_port_cache(jcache)
    jstep = jax.jit(lambda p, t, c, i: jtf.lm_decode_step(p, t, c, i, jcfg, PALLAS))
    jp = _jtree(tree)
    jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    for i in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jcache = jstep(jp, jtok[:, None].astype(jnp.int32), jcache, jnp.int32(13 + i))
        tl, cache = lm_decode_step(params, ttok[:, None], cache, 13 + i, cfg)
        _close(tl, jl, F32, f"decode step {i} logits")
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", MOE_IDS)
def test_prefill_and_decode_match_bfloat16(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _np_params(jcfg, 20)
    tokens = _tokens(21, 1, 11, cfg.vocab)
    (jl, jc), (tl, tc), params = _prefill_both(jcfg, cfg, tree, tokens, 16)
    assert all(c.dtype == torch.bfloat16 for c in _leaves(tc))
    _close(tl, jl, BF16, "bf16 prefill logits")
    for g, w in zip(_leaves(tc), jax.tree.leaves(jc)):
        _close(g, w, BF16, "bf16 prefill cache")
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(2):  # the same tokens on both sides, each on its own cache
        jl, jc = jtf.lm_decode_step(_jtree(tree), jnp.asarray(tok), jc, jnp.int32(11 + i), jcfg, PALLAS)
        tl, tc = lm_decode_step(params, torch.from_numpy(tok).long(), tc, 11 + i, cfg)
        _close(tl, jl, BF16, f"bf16 decode step {i} logits")
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", MOE_IDS)
def test_decode_over_more_than_128_slots_is_the_references_per_slot_step(arch, monkeypatch):
    """136 slots decode as one batch; each MoE layer routes them with room
    for all 136 tokens on every expert, and the logits are those of the
    reference's step, which vmaps a one-token decode over the slots."""
    jcfg, cfg = _cfgs(arch, "float32")
    tree = _np_params(jcfg, 60)
    b, s, max_len = 136, 3, 8
    tokens = _tokens(61, b, s, cfg.vocab)
    (jl, jc), (tl, _), params = _prefill_both(jcfg, cfg, tree, tokens, max_len)
    jcache = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jc)
    jrun = JRunner(jcfg, _jtree(tree), max_len=max_len, max_slots=b, policy=PALLAS)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    want, _ = jrun._step(jrun.params, jtok[:, None, None], jcache, jnp.full((b,), s, jnp.int32))
    caps, dispatch = [], tmoe._dispatch

    def recorded(x_flat, topi, capacity, n_experts):
        caps.append((topi.shape[0], capacity))
        return dispatch(x_flat, topi, capacity, n_experts)

    monkeypatch.setattr(tmoe, "_dispatch", recorded)
    got, _ = lm_decode_step(params, torch.argmax(tl, -1)[:, None], _to_port_cache(jcache), s, cfg)
    assert caps == [(b, b)] * cfg.layer_kinds().count("moe")
    _close(got, want, F32, "decode logits over 136 slots")


@pytest.mark.parametrize("arch", MOE_IDS)
def test_engine_outputs_match_float32(arch):
    jcfg, cfg = _cfgs(arch, "float32")
    tree = _np_params(jcfg, 40)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in (5, 9, 5, 9)]
    jeng = JEngine(jcfg, _jtree(tree), max_len=24, max_batch=2, policy=PALLAS)
    eng = Engine(cfg, lm_params_from_numpy(tree, device="cpu"), max_len=24, max_batch=2, device="cpu")
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_tokens=4 + rid))
        eng.submit(Request(rid=rid, prompt=prompt, max_tokens=4 + rid))
    want = {r.rid: r.output for r in jeng.run_until_done()}
    done = eng.run_until_done()
    assert not eng.failed
    assert {r.rid: r.output for r in done} == want
    assert eng.steps == jeng.steps
    assert all(c.dtype == torch.bfloat16 for c in _leaves(eng.runner.cache))


@pytest.mark.parametrize("arch", MOE_IDS)
def test_forward_runs_the_counted_norms_and_one_flash_a_layer(arch, monkeypatch):
    """What the card's launch counts hold: ``norms_per_forward`` RMSNorm
    calls per prefill and per decode step (3 L + 1 under MLA, with the
    latent's kv_norm), and one flash-attention call per layer per prefill,
    counted here at the wrappers the layers call."""
    import repro_torch.kernels.flash_attention as flash_pkg
    import repro_torch.kernels.rmsnorm as rms_pkg

    calls = {"rms": 0, "flash": 0}
    rms, flash = rms_pkg.rmsnorm, flash_pkg.flash_attention

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rms_pkg, "rmsnorm", count("rms", rms))
    monkeypatch.setattr(flash_pkg, "flash_attention", count("flash", flash))
    _, cfg = _cfgs(arch)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    logits, cache = lm_prefill(params, torch.tensor([[3, 4, 5, 6]]), cfg, max_len=8)
    assert calls == {"rms": norms_per_forward(cfg), "flash": cfg.n_layers}
    lm_decode_step(params, torch.argmax(logits, -1)[:, None], cache, 4, cfg)
    assert calls == {"rms": 2 * norms_per_forward(cfg), "flash": cfg.n_layers}
    assert norms_per_forward(cfg) == 2 * cfg.n_layers + 1 + (cfg.n_layers if cfg.mla else 0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_IDS)
def test_serve_cli_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                          "--device", "cpu", "--requests", "3", "--max-tokens", "4",
                          "--max-batch", "2"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"{arch}: served 3 requests, 12 tokens" in out.stdout
