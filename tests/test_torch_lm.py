"""The port's dense-LM serving path against the JAX reference, on the CPU.

Both sides get the same parameters (drawn with numpy and carried across
with ``lm_params_from_numpy``) and the same tokens. The reference runs
with ``ParallelPolicy(use_pallas=True)``, so its RMSNorm and flash
attention are the TPU kernels in interpret mode; the port's wrappers run
their plain versions on CPU tensors. Tolerances, stated where they are
used: with ``dtype="float32"`` prefill logits and caches within 1e-4 of
max|ref|, decode logits within 2e-3 of max|ref| (the KV cache is bf16, and
a k/v value that lands on the other side of a bf16 rounding boundary moves
by 2^-8 of itself), greedy tokens identical; at bf16, within 3e-2 of
max|ref| (bf16 rounds every activation, in another order on each side).
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
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.policy import ParallelPolicy
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs import ARCH_IDS, DENSE_IDS, SERVED_IDS, get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.models import (
    init_cache,
    init_lm_params,
    lm_decode_step,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_prefill,
)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.serve import SERVABLE_FAMILIES, Engine, Request, TransformerRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = ParallelPolicy(use_pallas=True)
F32_PREFILL, F32_DECODE, BF16 = 1e-4, 2e-3, 3e-2
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
BIASES = ("bq", "bk", "bv", "b1", "b2")


def _cfgs(arch, dtype=None):
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    if dtype:
        jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    return jcfg, cfg


def _np_params(jcfg, seed):
    """A parameter tree of the reference's shapes drawn with numpy: fan-in
    scaled weights, norms near 1, small non-zero biases."""
    shapes = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name in NORMS:
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in BIASES:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-1] if name == "embed" else shape[-2]
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    def walk(tree, name=None):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return draw(name, tuple(tree.shape))

    return walk(shapes)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|d|={err:.3e} > {rel} * max|ref|={scale:.3e}"


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_IDS)
def test_dense_configs_match_the_reference(arch):
    for full in (True, False):
        jcfg = jget_arch(arch) if full else jreduced(jget_arch(arch))
        cfg = get_arch(arch) if full else reduced(get_arch(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.head_dim_ == jcfg.head_dim_
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.approx_params() == jcfg.approx_params()
    assert reduced(get_arch(arch)).activation_dtype == torch.bfloat16


def test_gemma_7b_full_width_numbers():
    cfg = get_arch("gemma-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_) == (28, 3072, 16, 16, 256)
    assert abs(cfg.approx_params() - 9.32e9) < 0.01e9


@pytest.mark.parametrize("arch", sorted(set(ARCH_IDS) - set(SERVED_IDS)))
def test_other_families_name_their_roadmap_item(arch):
    """The one arch the token engine does not serve, whisper-tiny, is
    ported: its full-width numbers, as the reference's."""
    cfg = get_arch(arch)
    assert (cfg.family, cfg.n_layers, cfg.encoder.n_layers, cfg.encoder.frames) == ("encdec", 4, 4, 1500)
    assert (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab) == (
        384, 6, 6, 64, 1536, 51865)
    assert (cfg.norm, cfg.norm_eps, cfg.mlp_act, cfg.qkv_bias, cfg.rope_fraction) == (
        "ln", 1e-5, "gelu", True, 0.0)
    assert cfg.approx_params() == jget_arch(arch).approx_params() == 46_910_208


def test_unknown_arch_and_other_family_refusals():
    """An unknown arch or family is refused; the encoder-decoder family is
    cut and laid out as the reference's, and the token engine refuses it in
    the reference's words."""
    with pytest.raises(KeyError):
        get_arch("gpt-2")
    encdec = dataclasses.replace(get_arch("gemma-7b"), family="encdec")
    jencdec = dataclasses.replace(jget_arch("gemma-7b"), family="encdec")
    assert dataclasses.asdict(reduced(encdec)) == dataclasses.asdict(jreduced(jencdec))
    assert encdec.layer_kinds() == jencdec.layer_kinds() == ("dense",) * 28
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        dataclasses.replace(encdec, family="rnn").layer_kinds()
    with pytest.raises(ValueError, match="not servable by the token engine .*; encoder-decoder "
                                         "models go through the whisper_\\* entry points"):
        TransformerRunner(reduced(encdec), {}, device="cpu")
    assert SERVABLE_FAMILIES == ("dense", "moe", "ssm", "hybrid")
    with pytest.raises(ValueError, match="activation dtype"):
        ArchConfig("x", "dense", 1, 8, 1, 1, 8, 8, dtype="float16").activation_dtype


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-7b", "qwen1.5-32b", "minitron-8b", "chameleon-34b"])
def test_init_lm_params_has_the_reference_tree(arch):
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    got = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    np_got = lm_params_to_numpy(got)
    assert jax.tree.structure(np_got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(np_got), jax.tree.leaves(want)):
        assert g.shape == tuple(w.shape) and g.dtype == np.float32
    emb = np_got["embed"]
    assert abs(emb.std() * cfg.d_model ** 0.5 - 1) < 0.05


def test_params_round_trip_bitwise():
    jcfg, _ = _cfgs("qwen1.5-32b")
    tree = _np_params(jcfg, 3)
    back = lm_params_to_numpy(lm_params_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_points_need_a_device_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("gemma-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_params(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, {})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction,theta,pos2d,dtype", [
    (1.0, 10000.0, False, "float32"),
    (0.5, 10000.0, True, "float32"),
    (1.0, 1e6, True, "bfloat16"),
    (0.3, 10000.0, False, "bfloat16"),
])
def test_rope_matches(fraction, theta, pos2d, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7) + 5
    if pos2d:
        pos = np.stack([pos, pos * 3])
    jx = jnp.asarray(x, dtype)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), theta=theta, fraction=fraction)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), theta=theta, fraction=fraction)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2  # one bf16 rounding of the rotated part
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    inv, rot = tlayers.rope_frequencies(16, theta, fraction)
    jinv, jrot = jlayers.rope_frequencies(16, theta, fraction)
    assert rot == jrot
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlps_match(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    w_in = rng.standard_normal((8, 12)).astype(np.float32) / 3
    w_up = rng.standard_normal((8, 12)).astype(np.float32) / 3
    w_out = rng.standard_normal((12, 8)).astype(np.float32) / 3
    b1, b2 = rng.standard_normal(12).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    t = torch.from_numpy
    if act in ("swiglu", "geglu"):
        want = jlayers.glu_mlp(jnp.asarray(x), w_in, w_up, w_out, act=act)
        got = tlayers.glu_mlp(t(x), t(w_in), t(w_up), t(w_out), act=act)
    else:
        want = jlayers.gelu_mlp(jnp.asarray(x), w_in, b1, w_out, b2, act=act)
        got = tlayers.gelu_mlp(t(x), t(w_in), t(b1), t(w_out), t(b2), act=act)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_unported_layer_variants_name_their_roadmap_item():
    """Whisper's LayerNorm and plain-gelu MLP compute, in the decoder LM
    too: reduced gemma-7b with ``norm="ln"`` (each norm a LayerNorm with a
    zero bias, as the reference's ``_norm``) and the plain GELU against the
    reference's prefill at f32 within 1e-4 of max|ref|; its cache is made,
    and its norms launch no RMSNorm kernel."""
    x = torch.linspace(-3, 3, 16).reshape(1, 2, 8)
    w = (torch.eye(8, 4), torch.zeros(4), torch.eye(4, 8), torch.zeros(8))
    y = tlayers.gelu_mlp(x, *w)  # act defaults to "gelu", as the reference's
    assert torch.equal(y, tlayers.gelu_mlp(x, *w, act="gelu"))
    torch.testing.assert_close(y[..., :4], torch.nn.functional.gelu(x[..., :4]), rtol=1e-5, atol=1e-5)
    jcfg, cfg = _cfgs("gemma-7b", "float32")
    jcfg, cfg = (dataclasses.replace(c, norm="ln", mlp_act="gelu") for c in (jcfg, cfg))
    assert init_cache(cfg, 1, 8, device="cpu")["layers"]["k"].shape == (2, 1, 2, 8, 16)
    from repro_torch.models.transformer import norms_per_forward
    assert norms_per_forward(cfg) == 0
    tree = _np_params(jcfg, 21)
    tokens = _tokens(22, 2, 7, cfg.vocab)
    (jl, jc), (tl, tc), _ = _prefill_both(jcfg, cfg, tree, tokens, 9)
    _close(tl, jl, F32_PREFILL, "LayerNorm gemma prefill logits")
    _close(tc["layers"]["k"], jc["layers"]["k"], F32_PREFILL, "LayerNorm gemma prefill cache")


def test_windowed_gemma_matches_the_reference():
    """gemma-7b with a sliding window of 4 (which no served dense config
    has, and which the port refused before the hybrid family needed it): a
    9-token prompt takes the windowed path into a ring of 4, then decode
    steps across two wraps, at f32 on each side's own f32 cache."""
    jcfg, cfg = (dataclasses.replace(c, window=4) for c in _cfgs("gemma-7b", "float32"))
    tree = _np_params(jcfg, 12)
    tokens = _tokens(13, 2, 9, cfg.vocab)
    (jl, jc), (tl, tc), params = _prefill_both(jcfg, cfg, tree, tokens, 16)
    assert tc["layers"]["k"].shape[3] == 4
    _close(tl, jl, F32_PREFILL, "windowed prefill logits")
    jp, tok = _jtree(tree), np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(9, 14):
        for name in ("k", "v"):
            _close(tc["layers"][name], jc["layers"][name], F32_PREFILL, f"ring {name} at {i}")
        jl, jc = jtf.lm_decode_step(jp, jnp.asarray(tok), jc, jnp.int32(i), jcfg, PALLAS)
        tl, tc = lm_decode_step(params, torch.from_numpy(tok).long(), tc, i, cfg)
        _close(tl, jl, F32_PREFILL, f"windowed decode at index {i} logits")
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("scale", [False, True])
def test_embed_and_logits_last_match(scale):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    tokens = rng.integers(0, 50, size=(2, 6))
    want = jlayers.embed(jnp.asarray(table), jnp.asarray(tokens), scale_by_sqrt_dim=scale)
    got = tlayers.embed(torch.from_numpy(table), torch.from_numpy(tokens), scale_by_sqrt_dim=scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    head = rng.standard_normal((16, 50)).astype(np.float32)
    h = jnp.asarray(np.asarray(want)[:, -1], jnp.bfloat16)
    want_l = jlayers.logits_last(h, jnp.asarray(head))
    got_l = tlayers.logits_last(torch.from_numpy(_f32(h)).bfloat16(), torch.from_numpy(head))
    assert got_l.dtype == torch.float32
    _close(got_l, want_l, 1e-2, "bf16 logits_last")


def test_norms_match():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), use_pallas=True)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decode_attention_matches():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(ml_dtypes.bfloat16)
    v = rng.standard_normal((2, 2, 9, 16)).astype(ml_dtypes.bfloat16)
    valid = np.arange(9)[None, :] <= np.array([[4], [8]])
    from repro.models import attention as jattn

    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid))

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16()

    got = tattn.decode_attention(torch.from_numpy(q), bf(k), bf(v), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attn_decode_on_a_per_layer_cache_matches():
    """``init_kv_cache`` + ``attn_decode`` (one layer, scalar index) vs the
    reference's on the same cache contents."""
    from repro.models import attention as jattn

    jcfg, cfg = _cfgs("chatglm3-6b", "float32")
    p_np = jax.tree.map(lambda a: a[0], _np_params(jcfg, 9)["layers"]["attn"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    prefix = rng.standard_normal((2, cfg.kv_heads, 6, cfg.head_dim_)).astype(np.float32)
    jcache = jattn.init_kv_cache(jcfg, 2, 8)
    jcache = {n: c.at[:, :, :6].set(jnp.asarray(prefix, jnp.bfloat16)) for n, c in jcache.items()}
    want, jnew = jattn.attn_decode(_jtree(p_np), jnp.asarray(x), jcache, jnp.int32(6), jcfg)
    cache = tattn.init_kv_cache(cfg, 2, 8, device="cpu")
    for c in cache.values():
        c[:, :, :6] = torch.from_numpy(prefix)
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    got, new = tattn.attn_decode(p, torch.from_numpy(x), cache, torch.tensor([6, 6]), cfg)
    assert new is cache
    _close(got, want, F32_DECODE, "attn_decode out")
    _close(new["k"], jnew["k"], F32_DECODE, "attn_decode cache")


# ---------------------------------------------------------------------------
# the slice: prefill, decode and Engine per dense config
# ---------------------------------------------------------------------------

def _prefill_both(jcfg, cfg, tree, tokens, max_len):
    jlogits, jcache = jax.jit(
        lambda p, t: jtf.lm_prefill(p, t, jcfg, PALLAS, max_len=max_len))(_jtree(tree), tokens)
    params = lm_params_from_numpy(tree, device="cpu")
    logits, cache = lm_prefill(params, torch.from_numpy(tokens).long(), cfg, max_len=max_len)
    return (jlogits, jcache), (logits, cache), params


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_prefill_and_decode_match_float32(arch):
    jcfg, cfg = _cfgs(arch, "float32")
    tree = _np_params(jcfg, 10)
    tokens = _tokens(11, 2, 13, cfg.vocab)
    max_len, steps = 24, 4
    (jl, jc), (tl, tc), params = _prefill_both(jcfg, cfg, tree, tokens, max_len)
    _close(tl, jl, F32_PREFILL, "prefill logits")
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name], F32_PREFILL, f"prefill cache {name}")
    # decode on the serving path's bf16 cache, greedy tokens from each side
    jcache = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jc)
    cache = init_cache(cfg, 2, max_len, device="cpu")
    for name in ("k", "v"):
        cache["layers"][name].copy_(tc["layers"][name])
    jstep = jax.jit(lambda p, t, c, i: jtf.lm_decode_step(p, t, c, i, jcfg, PALLAS))
    jp = _jtree(tree)
    jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    for i in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jcache = jstep(jp, jtok[:, None].astype(jnp.int32), jcache, jnp.int32(13 + i))
        tl, cache = lm_decode_step(params, ttok[:, None], cache, 13 + i, cfg)
        _close(tl, jl, F32_DECODE, f"decode step {i} logits")
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_prefill_and_decode_match_bfloat16(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _np_params(jcfg, 20)
    tokens = _tokens(21, 1, 11, cfg.vocab)
    (jl, jc), (tl, tc), params = _prefill_both(jcfg, cfg, tree, tokens, 16)
    assert tc["layers"]["k"].dtype == torch.bfloat16
    _close(tl, jl, BF16, "bf16 prefill logits")
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name], BF16, f"bf16 prefill cache {name}")
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(2):  # the same tokens and caches on both sides, as carried
        jl, jc = jtf.lm_decode_step(_jtree(tree), jnp.asarray(tok), jc, jnp.int32(11 + i), jcfg, PALLAS)
        tl, tc = lm_decode_step(params, torch.from_numpy(tok).long(), tc, 11 + i, cfg)
        _close(tl, jl, BF16, f"bf16 decode step {i} logits")
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ["gemma-7b", "chatglm3-6b"])
def test_batched_decode_with_per_slot_indices_matches_per_slot_reference(arch):
    """Two slots at different positions decoded as one batch vs the
    reference's batch-1 step on each slot."""
    jcfg, cfg = _cfgs(arch, "float32")
    tree = _np_params(jcfg, 30)
    params = lm_params_from_numpy(tree, device="cpu")
    jp, max_len = _jtree(tree), 20
    cache = init_cache(cfg, 2, max_len, device="cpu")
    next_tok, want = [], []
    for slot, n in enumerate((5, 12)):
        tokens = _tokens(31 + slot, 1, n, cfg.vocab)
        jl, jc = jtf.lm_prefill(jp, jnp.asarray(tokens), jcfg, PALLAS, max_len=max_len)
        jc = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jc)
        tok = int(jnp.argmax(jl[0]))
        wl, _ = jtf.lm_decode_step(jp, jnp.asarray([[tok]], jnp.int32), jc, jnp.int32(n), jcfg, PALLAS)
        want.append(np.asarray(wl[0]))
        _, tc = lm_prefill(params, torch.from_numpy(tokens).long(), cfg, max_len=max_len)
        for name in ("k", "v"):
            cache["layers"][name][:, slot] = tc["layers"][name][:, 0]
        next_tok.append(tok)
    got, _ = lm_decode_step(params, torch.tensor(next_tok)[:, None], cache, [5, 12], cfg)
    _close(got, np.stack(want), F32_DECODE, "batched decode logits")


@pytest.mark.parametrize("arch", DENSE_IDS)
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
    runner = eng.runner
    assert len(runner.prefill_s) == 4 and len(runner.decode_s) == eng.steps
    assert runner.cache["layers"]["k"].dtype == torch.bfloat16


def test_runner_holds_bf16_matmul_weights_and_f32_norms_and_embed():
    jcfg, cfg = _cfgs("qwen1.5-32b")
    params = lm_params_from_numpy(_np_params(jcfg, 50), device="cpu")
    runner = TransformerRunner(cfg, params, max_len=8, max_slots=2, device="cpu")
    p = runner.params
    assert p["embed"].dtype == torch.float32 and p["final_norm"].dtype == torch.float32
    assert p["layers"]["ln1"].dtype == torch.float32
    assert p["lm_head"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["bq"].dtype == torch.bfloat16
    assert torch.equal(p["layers"]["attn"]["wq"], params["layers"]["attn"]["wq"].bfloat16())


def test_admit_writes_the_whole_slot_row_and_only_it():
    """A slot reused by a shorter prompt holds that prompt's k/v and zeros
    past it, bitwise what a fresh prefill cast to the bf16 cache holds."""
    _, cfg = _cfgs("qwen1.5-32b", "float32")
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    runner = TransformerRunner(cfg, params, max_len=12, max_slots=2, device="cpu")
    runner.admit(0, Request(rid=0, prompt=list(range(1, 10))))
    short = [5, 6, 7]
    runner.admit(0, Request(rid=1, prompt=short))
    _, fresh = lm_prefill(runner.params, torch.tensor([short]), cfg, max_len=12)
    for name in ("k", "v"):
        row = runner.cache["layers"][name]
        assert torch.equal(row[:, 0], fresh["layers"][name][:, 0].bfloat16())
        assert not row[:, 0, :, :3].eq(0).all() and row[:, 0, :, 3:].eq(0).all()
        assert row[:, 1].eq(0).all()


def test_prompt_longer_than_max_len_fails_the_request_only():
    _, cfg = _cfgs("gemma-7b")
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, params, max_len=8, max_batch=2, device="cpu")
    eng.submit(Request(rid=0, prompt=list(range(1, 10)), max_tokens=2))
    eng.submit(Request(rid=1, prompt=[1, 2, 3], max_tokens=2))
    done = eng.run_until_done()
    assert [r.rid for r in done] == [1] and [r.rid for r in eng.failed] == [0]
    assert isinstance(eng.failed[0].error, ValueError)


def test_cpu_serving_launches_no_kernel():
    _, cfg = _cfgs("gemma-7b")
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    before = (rmsnorm_cuda.launches, flash_attention_cuda.launches)
    eng = Engine(cfg, params, max_len=16, max_batch=2, device="cpu")
    eng.submit(Request(rid=0, prompt=[3, 4, 5], max_tokens=3))
    assert len(eng.run_until_done()[0].output) == 3
    assert (rmsnorm_cuda.launches, flash_attention_cuda.launches) == before


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, timeout=300, cwd=REPO)


def test_serve_cli_on_the_cpu():
    out = _cli("--device", "cpu", "--requests", "3", "--max-tokens", "4", "--max-batch", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "gemma-7b: served 3 requests, 12 tokens" in out.stdout
    assert "kernel launches" not in out.stdout


def test_serve_cli_refuses_without_a_card_and_names_unported_archs():
    out = _cli("--requests", "1", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = _cli("--arch", "whisper-tiny", "--device", "cpu")
    assert out.returncode != 0 and "Queue 1 item 5" not in out.stderr
    assert ("--arch whisper-tiny (family 'encdec') is not servable by the token engine" in out.stderr
            and "Encoder-decoder archs are served via the whisper_* entry points" in out.stderr)


# ---------------------------------------------------------------------------
# on the card: the served path through the kernels vs through the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE_IDS)
def test_reduced_prefill_and_decode_on_card_match_plain(arch, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import repro_torch.kernels.flash_attention as flash_ops
    import repro_torch.kernels.rmsnorm as rms_ops
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.models.transformer import serving_params

    _, cfg = _cfgs(arch)
    dev = torch.device("cuda")
    params = serving_params(init_lm_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                           device=dev), cfg, dev)
    tokens = torch.from_numpy(_tokens(60, 1, 37, cfg.vocab)).long().to(dev)

    def run():
        logits, cache = lm_prefill(params, tokens, cfg, max_len=40)
        nxt = torch.argmax(logits, -1)[:, None]
        step, _ = lm_decode_step(params, nxt, cache, 37, cfg)
        return logits, step

    before = (rmsnorm_cuda.launches, flash_attention_cuda.launches)
    got = run()
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    assert rmsnorm_cuda.launches - before[0] == 2 * norms
    assert flash_attention_cuda.launches - before[1] == cfg.n_layers
    monkeypatch.setattr(rms_ops, "rmsnorm", lambda x, w, eps=1e-6: rmsnorm_ref(x, w, eps))
    monkeypatch.setattr(flash_ops, "flash_attention", flash_attention_ref)
    want = run()
    for g, w, what in zip(got, want, ("prefill", "decode")):
        _close(g.cpu(), w.cpu(), BF16, f"{what} logits, kernels vs plain")
