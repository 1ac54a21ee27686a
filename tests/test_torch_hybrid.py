"""The port's hybrid family (RecurrentGemma) against the JAX reference, on the CPU.

The RG-LRU mixer (``_rglru_scan``, ``rglru_forward`` with the prefill's
cache, ``rglru_decode``), the sliding window (``_windowed_attention``, the
prefill's ring, the ring decode across its wrap with per-row indices),
then as slices reduced recurrentgemma-2b (one superblock of rec, rec,
attn) and a 5-layer hybrid (one superblock and a tail of two rec layers,
so the tail list is covered): prefill, decode, ``Engine`` and the CLI,
with prompts longer than the window and decodes past the ring's wrap.
Inputs are drawn with numpy and carried across
(``lm_params_from_numpy``); the reference runs with
``ParallelPolicy(use_pallas=True)``, so its RMSNorm and flash attention are
the TPU kernels in interpret mode, while the port's wrappers run their
plain versions on CPU tensors. Tolerances, stated where they are used: the
mixers and attention at f32 within rtol 1e-4 / atol 1e-5 (the scan sums in
another order than XLA's tree); ring caches bitwise (integer-valued
inputs, no RoPE, so k and v are exact on both sides); the slices at f32
within 1e-4 of max|ref|, greedy tokens identical, at bf16 within 3e-2 of
max|ref|.
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

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models import transformer as jtf
from repro.models.policy import ParallelPolicy
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs import get_arch, reduced
from repro_torch.models import (
    init_cache,
    init_lm_params,
    lm_decode_step,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_prefill,
)
from repro_torch.models import attention as tattn
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttf
from repro_torch.serve import Engine, Request, TransformerRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = ParallelPolicy(use_pallas=True)
ARCH = "recurrentgemma-2b"
RTOL, ATOL = 1e-4, 1e-5
F32, BF16 = 1e-4, 3e-2
NORMS = ("ln1", "ln2", "final_norm")
# reduced recurrentgemma (3 layers: one superblock) and 5 layers (a tail of 2)
LAYERS = (3, 5)


def _cfgs(dtype=None, n_layers=3):
    jcfg, cfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    jcfg, cfg = (dataclasses.replace(c, n_layers=n_layers, dtype=dtype or c.dtype) for c in (jcfg, cfg))
    return jcfg, cfg


def _draw(rng, name, shape):
    def normal(scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if name in NORMS:
        return (1 + normal(0.1)).astype(np.float32)
    if name == "lambda":
        return np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, shape)))).astype(np.float32)
    if name in ("conv_b", "b_r", "b_i"):
        return normal(0.1)
    if name == "conv_w":
        return normal(0.3)
    return normal((shape[-1] if name == "embed" else shape[-2]) ** -0.5)


def _np_params(jcfg, seed):
    """A parameter tree of the reference's shapes (dicts and the tail's
    list) drawn with numpy."""
    shapes = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return _draw(rng, name, tuple(tree.shape))

    return walk(shapes)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|d|={err:.3e} > {rel} * max|ref|={scale:.3e}"


def _allclose(got, want, what):
    assert np.isfinite(_f32(got)).all(), what
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _leaves(tree):
    """A tree's leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    for full in (True, False):
        jcfg = jget_arch(ARCH) if full else jreduced(jget_arch(ARCH))
        cfg = get_arch(ARCH) if full else reduced(get_arch(ARCH))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.approx_params() == jcfg.approx_params()
        assert cfg.rglru.width(cfg.d_model) == jcfg.rglru.width(jcfg.d_model)
    cfg = get_arch(ARCH)
    assert ttf.hybrid_layout(cfg) == (("rec", "rec", "attn"), 8, 2)
    assert ttf.hybrid_layout(reduced(cfg))[1:] == (1, 0)
    # the reference's count leaves out the rec layers' MLPs (2.49 B, not ~3.55 B)
    assert abs(cfg.approx_params() - 2.488e9) < 1e6
    assert ttf.norms_per_forward(cfg) == 53 and ttf.attention_layers(cfg) == 8
    assert ttf.flash_per_prefill(cfg, 2048) == 8 and ttf.flash_per_prefill(cfg, 2300) == 0


# ---------------------------------------------------------------------------
# the RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 17, 300])
def test_rglru_scan_matches_reference_and_loop(s):
    rng = np.random.default_rng(s)
    b, w = 2, 8
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    r = 1 / (1 + np.exp(-rng.standard_normal((b, s, w)))).astype(np.float32)
    i = 1 / (1 + np.exp(-rng.standard_normal((b, s, w)))).astype(np.float32)
    lam = rng.standard_normal(w).astype(np.float32)
    want = jrglru._rglru_scan(*map(jnp.asarray, (x, r, i, lam)))
    got = trglru._rglru_scan(*map(_t, (x, r, i, lam)))
    _allclose(got, want, "scan vs reference")
    log_a = -8.0 * np.log1p(np.exp(lam.astype(np.float64))) * r
    gated = np.sqrt(np.maximum(1 - np.exp(2 * log_a), 1e-12)) * (i * x)
    h, loop = np.zeros((b, w)), np.zeros((b, s, w))
    for t in range(s):
        h = np.exp(log_a[:, t]) * h + gated[:, t]
        loop[:, t] = h
    _allclose(got, loop, "scan vs the loop")


def _mixer(seed, d_model=32):
    jcfg, _ = _cfgs("float32")
    jcfg = dataclasses.replace(jcfg, d_model=d_model)
    shapes = jax.eval_shape(lambda: jrglru.init_rglru_params(jax.random.PRNGKey(0), d_model, jcfg.rglru))
    rng = np.random.default_rng(seed)
    p_np = {k: _draw(rng, k, tuple(v.shape)) for k, v in shapes.items()}
    return jcfg, p_np, {k: _t(v) for k, v in p_np.items()}


@pytest.mark.parametrize("s", [2, 23], ids=["s2-below-conv-kernel", "s23"])
def test_rglru_forward_prefill_cache_and_decode_match(s):
    """The forward, the cache the reference's ``_rglru_prefill`` recomputes
    (from the port's one scan), then three decode steps on each side's
    own cache, the port's updated in place."""
    jcfg, p_np, p = _mixer(21)
    d, cfg = jcfg.d_model, jcfg.rglru
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    want = jrglru.rglru_forward(_jtree(p_np), jnp.asarray(x), cfg, d)
    _, jcache = jtf._rglru_prefill(_jtree(p_np), jnp.asarray(x), jcfg)
    got, cache = trglru.rglru_forward(p, _t(x), cfg, d, return_cache=True)
    _allclose(got, want, "rglru_forward out")
    _allclose(cache["conv"], jcache["conv"], "conv cache")
    _allclose(cache["h"], jcache["h"], "h cache")
    assert all(c.dtype == torch.float32 for c in cache.values())
    assert {k: tuple(v.shape) for k, v in trglru.init_rglru_cache(d, cfg, 2).items()} == {
        k: tuple(v.shape) for k, v in jrglru.init_rglru_cache(d, cfg, 2).items()}
    for step in range(3):
        xt = rng.standard_normal((2, 1, d)).astype(np.float32)
        want, jcache = jrglru.rglru_decode(_jtree(p_np), jnp.asarray(xt), jcache, cfg, d)
        got, new = trglru.rglru_decode(p, _t(xt), cache, cfg, d)
        assert new is cache
        _allclose(got, want, f"decode step {step} out")
        _allclose(cache["conv"], jcache["conv"], f"decode step {step} conv")
        _allclose(cache["h"], jcache["h"], f"decode step {step} h")


# ---------------------------------------------------------------------------
# sliding windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_attention_matches(dtype):
    """s = 40 past a window of 16 (end-padded to 48, three blocks), MQA."""
    rng = np.random.default_rng(31)
    q = jnp.asarray(rng.standard_normal((2, 4, 40, 16)), dtype)
    k = jnp.asarray(rng.standard_normal((2, 1, 40, 16)), dtype)
    v = jnp.asarray(rng.standard_normal((2, 1, 40, 16)), dtype)
    want = jattn._windowed_attention(q, k, v, 16)
    got = tattn._windowed_attention(*(_t(_f32(a)).to(getattr(torch, dtype)) for a in (q, k, v)), 16)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _allclose(got, want, "windowed attention")
    else:  # bf16 rounds the logits, the weights and the output
        _close(got, want, BF16, "bf16 windowed attention")


def _exact_attn(seed, cfg):
    """Integer-valued attention weights of cfg's shapes (products and sums
    of small integers are exact in f32 and bf16 on both sides)."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim_
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.kv_heads * hd),
              "wv": (d, cfg.kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    p_np = {k: rng.integers(-1, 2, size=s).astype(np.float32) / 4 for k, s in shapes.items()}
    return p_np, {k: _t(v) for k, v in p_np.items()}


@pytest.mark.parametrize("s,max_len", [(10, 48), (16, 48), (40, 48), (37, 12), (5, 12)],
                         ids=["s<w", "s=w", "s>w", "s>ring<w", "s<ring<w"])
def test_prefill_ring_is_the_references_bitwise(s, max_len):
    """The ring a prefill writes: the prompt and zeros past it when it is
    shorter than the ring, else its last S positions rolled to slot t % S;
    S = min(max_len, window)."""
    jcfg, cfg = (dataclasses.replace(c, rope_fraction=0.0) for c in _cfgs("float32"))
    p_np, p = _exact_attn(41, cfg)
    h = np.random.default_rng(42).integers(-2, 3, size=(2, s, cfg.d_model)).astype(np.float32)
    positions = np.arange(s)
    want, jcache = jtf._attn_prefill(_jtree(p_np), jnp.asarray(h), jcfg, PALLAS,
                                     jnp.asarray(positions), max_len)
    lc = tattn.init_kv_cache(cfg, 2, max_len, dtype=torch.float32)
    lc["k"].fill_(7.0)  # a stale row: the prefill writes the ring whole
    got = ttf._attn_prefill(p, _t(h), cfg, torch.from_numpy(positions), lc)
    assert lc["k"].shape[2] == min(max_len, cfg.window)
    for name in ("k", "v"):
        np.testing.assert_array_equal(lc[name].numpy(), np.asarray(jcache[name]), err_msg=name)
    _allclose(got, want, "prefill attention out")


def test_ring_decode_across_the_wrap_with_per_row_indices():
    """Three rows at their own index decoded as one batch: before the wrap,
    at index S (slot 0, every slot valid) and far past it, against the
    reference's batch-1 step on each row, over ring contents the rows
    share; written slots bitwise."""
    jcfg, cfg = (dataclasses.replace(c, rope_fraction=0.0) for c in _cfgs("float32"))
    p_np, p = _exact_attn(51, cfg)
    rng = np.random.default_rng(52)
    s_ring = cfg.window
    ring = rng.integers(-3, 4, size=(3, cfg.kv_heads, s_ring, cfg.head_dim_)).astype(np.float32)
    x = rng.integers(-2, 3, size=(3, 1, cfg.d_model)).astype(np.float32)
    index = [9, 16, 45]
    cache = {"k": torch.from_numpy(ring.copy()).bfloat16(), "v": torch.from_numpy(-ring).bfloat16()}
    got, new = tattn.attn_decode(p, _t(x), cache, torch.tensor(index), cfg)
    assert new is cache
    for row, i in enumerate(index):
        jc = {"k": jnp.asarray(ring[row:row + 1], jnp.bfloat16),
              "v": jnp.asarray(-ring[row:row + 1], jnp.bfloat16)}
        want, jnew = jattn.attn_decode(_jtree(p_np), jnp.asarray(x[row:row + 1]), jc,
                                       jnp.int32(i), jcfg, PALLAS)
        _allclose(got[row:row + 1], want, f"row {row} at index {i}")
        for name in ("k", "v"):
            np.testing.assert_array_equal(_f32(cache[name][row:row + 1]), _f32(jnew[name]))
    assert cache["k"][1, :, 0].ne(torch.from_numpy(ring[1, :, 0]).bfloat16()).any()


# ---------------------------------------------------------------------------
# the slices: reduced recurrentgemma-2b and a 5-layer hybrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", LAYERS)
def test_param_and_cache_trees_match_the_reference(n_layers):
    jcfg, cfg = _cfgs(n_layers=n_layers)
    want = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert len(params["tail"]) == n_layers - 3 and isinstance(params["tail"], list)
    got = lm_params_to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == tuple(w.shape) and g.dtype == np.float32
    tree = _np_params(jcfg, 3)  # the reference's tree, the tail list included, round trips
    back = lm_params_to_numpy(lm_params_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jcache = jtf.init_cache(jcfg, 3, 40)
    cache = init_cache(cfg, 3, 40, device="cpu")
    assert jax.tree.structure(lm_params_to_numpy(cache)) == jax.tree.structure(jcache)
    for g, w in zip(_leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(g.shape) == tuple(w.shape) and not g.any()
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("n_layers,dtype", [(3, "bfloat16"), (5, "bfloat16"), (5, "float32")])
def test_leaf_by_leaf_serving_draw_is_bitwise_the_cast_masters(n_layers, dtype):
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), n_layers=n_layers, dtype=dtype)
    cpu = torch.device("cpu")
    want = ttf.serving_params(init_lm_params(cfg, generator=torch.Generator().manual_seed(3),
                                             device=cpu), cfg, cpu)
    got = init_lm_params(cfg, generator=torch.Generator().manual_seed(3), device=cpu, serving=True)
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(_leaves(want)) and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs)
    for mixer in [got["superblocks"]["b0_rec"]["mixer"]] + [t["mixer"] for t in got["tail"]]:
        for name in ("w_r", "b_r", "w_i", "b_i", "lambda", "conv_w", "conv_b"):
            assert mixer[name].dtype == torch.float32, name
        assert mixer["w_x"].dtype == mixer["w_out"].dtype == cfg.activation_dtype
    lam = got["superblocks"]["b0_rec"]["mixer"]["lambda"]
    a = torch.exp(-torch.nn.functional.softplus(lam))  # a^(1/c) in [0.9, 0.999]
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def _prefill_both(jcfg, cfg, tree, tokens, max_len):
    jlogits, jcache = jax.jit(
        lambda p, t: jtf.lm_prefill(p, t, jcfg, PALLAS, max_len=max_len))(_jtree(tree), tokens)
    params = lm_params_from_numpy(tree, device="cpu")
    logits, cache = lm_prefill(params, torch.from_numpy(tokens).long(), cfg, max_len=max_len)
    return (jlogits, jcache), (logits, cache), params


@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("dtype,rel", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("s", [12, 40], ids=["within-window", "past-window"])
def test_prefill_and_decode_match(n_layers, dtype, rel, s):
    """A prompt within the window (flash) or past it (the windowed path,
    a rolled ring), then decode steps across the ring's wrap at the next
    multiple of 16, each side on its own cache, the same tokens."""
    jcfg, cfg = _cfgs(dtype, n_layers)
    tree = _np_params(jcfg, 10 + n_layers)
    tokens = _tokens(11, 2, s, cfg.vocab)
    (jl, jc), (tl, tc), params = _prefill_both(jcfg, cfg, tree, tokens, 64)
    _close(tl, jl, rel, "prefill logits")
    for g, w in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert g.shape == tuple(w.shape)
        _close(g, w, rel, "prefill cache")
    jstep = jax.jit(lambda p, t, c, i: jtf.lm_decode_step(p, t, c, i, jcfg, PALLAS))
    jp = _jtree(tree)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(s, -(-(s + 1) // 16) * 16 + 2):  # past the next wrap
        jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.int32(i))
        tl, tc = lm_decode_step(params, torch.from_numpy(tok).long(), tc, i, cfg)
        _close(tl, jl, rel, f"decode at index {i} logits")
        if dtype == "float32":
            np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), np.asarray(jnp.argmax(jl, -1)))
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for g, w in zip(_leaves(tc), jax.tree.leaves(jc)):
        _close(g, w, rel, "cache after the decode")


@pytest.mark.parametrize("n_layers", LAYERS)
def test_engine_outputs_match_float32(n_layers):
    """Prompts within and past the window on two slots, decoding across
    the ring's wrap; slots reused by shorter prompts."""
    jcfg, cfg = _cfgs("float32", n_layers)
    tree = _np_params(jcfg, 40 + n_layers)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in (20, 6, 12, 3)]
    jeng = JEngine(jcfg, _jtree(tree), max_len=40, max_batch=2, policy=PALLAS)
    eng = Engine(cfg, lm_params_from_numpy(tree, device="cpu"), max_len=40, max_batch=2, device="cpu")
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_tokens=(6, 5, 9, 3)[rid]))
        eng.submit(Request(rid=rid, prompt=prompt, max_tokens=(6, 5, 9, 3)[rid]))
    want = {r.rid: r.output for r in jeng.run_until_done()}
    done = eng.run_until_done()
    assert not eng.failed
    assert {r.rid: r.output for r in done} == want
    assert eng.steps == jeng.steps
    ring = eng.runner.cache["superblocks"]["b2_attn"]["k"]
    assert ring.dtype == torch.bfloat16 and ring.shape[3] == cfg.window


def test_admit_overwrites_the_slot_whole():
    """A slot reused by a shorter prompt holds what a fresh prefill into a
    zeroed row holds: its ring (zeros past the prompt), conv and h."""
    _, cfg = _cfgs("float32", 5)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    runner = TransformerRunner(cfg, params, max_len=24, max_slots=2, device="cpu")
    runner.admit(0, Request(rid=0, prompt=list(range(1, 21))))
    runner.step([Request(rid=0, prompt=[1], output=[3]), None], [])
    runner.admit(0, Request(rid=1, prompt=[5, 6, 7]))
    fresh = init_cache(cfg, 1, 24, device="cpu")
    lm_prefill(runner.params, torch.tensor([[5, 6, 7]]), cfg, cache=fresh)
    row = ttf.cache_rows(runner.cache, 0, 1)
    pairs = list(zip(_leaves(row), _leaves(fresh)))
    assert len(pairs) == 3 * 2 + 2 * 2
    assert all(torch.equal(g, w) for g, w in pairs)
    assert row["superblocks"]["b2_attn"]["k"][..., 3:, :].eq(0).all()


def test_forward_counts_norms_and_flash_within_the_window_only(monkeypatch):
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
    _, cfg = _cfgs(n_layers=5)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    norms = ttf.norms_per_forward(cfg)
    for s, flash_calls in ((16, 1), (17, 0)):
        calls.update(rms=0, flash=0)
        logits, cache = lm_prefill(params, torch.arange(1, s + 1)[None], cfg, max_len=24)
        assert calls == {"rms": norms, "flash": flash_calls} == {
            "rms": 11, "flash": ttf.flash_per_prefill(cfg, s)}
        lm_decode_step(params, torch.argmax(logits, -1)[:, None], cache, s, cfg)
        assert calls == {"rms": 2 * norms, "flash": flash_calls}


def test_serve_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                          "--device", "cpu", "--requests", "3", "--max-tokens", "4",
                          "--max-batch", "2"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"{ARCH}: served 3 requests, 12 tokens" in out.stdout

