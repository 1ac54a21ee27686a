"""The port's encoder-decoder family (whisper) against the JAX reference, on the CPU.

Reduced whisper-tiny (2 + 2 layers, d_model 64, 4 heads over 2 kv heads
of 16, 12 stub frames). Both sides get the same parameters (drawn with
numpy, carried across with ``whisper_params_from_numpy``), frames and
tokens. The reference runs once on its plain path (``LOCAL``) and once
with ``ParallelPolicy(use_pallas=True)``, whose flash attention is the TPU
kernel in interpret mode; the port's wrapper runs its plain version on CPU
tensors. Tolerances, stated where they are used: the layers at f32 within
1e-5; the model's outputs (encoder states, hidden states, loss, logits,
caches) at f32 within 1e-4 of max|ref|; at bf16 within 3e-2 of max|ref|
(bf16 rounds every activation, in another order on each side).
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
from repro.models import layers as jlayers
from repro.models import whisper as jwhisper
from repro.models.policy import LOCAL, ParallelPolicy
from repro_torch.configs import ENCDEC_IDS, get_arch, reduced
from repro_torch.models import (
    init_whisper_cache,
    init_whisper_params,
    whisper_decode_step,
    whisper_loss,
    whisper_params_from_numpy,
    whisper_params_to_numpy,
    whisper_prefill,
)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import whisper as twhisper
from repro_torch.serve import Engine, TransformerRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-tiny"
PALLAS = ParallelPolicy(use_pallas=True)
POLICIES = {"plain": LOCAL, "pallas": PALLAS}
LAYER_TOL = 1e-5
F32, BF16 = 1e-4, 3e-2
BIASES = ("b", "bq", "bk", "bv", "b1", "b2")


def _cfgs(dtype=None):
    jcfg, cfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    if dtype:
        jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    return jcfg, cfg


def _ref_shapes(jcfg):
    return jax.eval_shape(lambda: jwhisper.init_whisper_params(jax.random.PRNGKey(0), jcfg))


def _np_params(jcfg, seed):
    """A parameter tree of the reference's shapes drawn with numpy: fan-in
    scaled weights, LayerNorm weights near 1, small non-zero biases."""
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "w":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in BIASES:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-1] if name == "embed" else shape[-2]
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return draw(name, tuple(tree.shape))

    return walk(_ref_shapes(jcfg))


def _inputs(cfg, seed, b=2, s=9):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.encoder.frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab, size=(b, s)).astype(np.int32)
    return frames, tokens


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


def _paths(tree, prefix=()):
    """{path: shape} of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _paths(v, prefix + (k,)).items()}
    return {prefix: tuple(tree.shape)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    for full in (True, False):
        jcfg = jget_arch(ARCH) if full else jreduced(jget_arch(ARCH))
        cfg = get_arch(ARCH) if full else reduced(get_arch(ARCH))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.head_dim_ == jcfg.head_dim_
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.approx_params() == jcfg.approx_params()
    cfg = reduced(get_arch(ARCH))
    assert ENCDEC_IDS == (ARCH,)
    assert (cfg.n_layers, cfg.encoder.n_layers, cfg.encoder.frames) == (2, 2, 12)
    assert (cfg.n_heads, cfg.kv_heads, cfg.head_dim_) == (4, 2, 16)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("piece", ["layer_norm", "gelu_mlp", "sinusoid", "chunked_cross_entropy"])
def test_layers_match(piece):
    rng = np.random.default_rng(1)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    if piece == "layer_norm":
        x, w, b = r(3, 5, 48, scale=3.0) + 2.0, 1 + r(48, scale=0.1), r(48, scale=0.1)
        want = jlayers.layer_norm(jnp.asarray(x), w, b, eps=1e-5)
        got = tlayers.layer_norm(_t(x), _t(w), _t(b), eps=1e-5)
    elif piece == "gelu_mlp":
        x, w1, b1, w2, b2 = r(2, 7, 32), r(32, 64, scale=0.2), r(64), r(64, 32, scale=0.1), r(32)
        want = jlayers.gelu_mlp(jnp.asarray(x), w1, b1, w2, b2)
        got = tlayers.gelu_mlp(*map(_t, (x, w1, b1, w2, b2)))
    elif piece == "sinusoid":
        # XLA's f32 exp is an ulp off the correctly rounded value at 22 of
        # whisper-tiny's 192 frequencies, which a position p turns into p
        # ulps of the angle: within 1e-5 plus that, p * 2^-23
        pos = np.array([0, 1, 7, 63, 448, 1499], np.int32)
        want = _f32(jwhisper._sinusoid(jnp.asarray(pos), 384))
        got = _f32(twhisper._sinusoid(torch.from_numpy(pos), 384))
        assert (np.abs(got - want) <= LAYER_TOL + pos[:, None] * 2.0 ** -23).all()
        np.testing.assert_allclose(got[:4], want[:4], rtol=LAYER_TOL, atol=LAYER_TOL)
        return
    else:
        h, head = r(2, 24, 32), r(32, 96, scale=0.5)
        tgt = rng.integers(0, 96, size=(2, 24)).astype(np.int32)
        want = jlayers.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(head), jnp.asarray(tgt),
                                             chunk=8)
        got = tlayers.chunked_cross_entropy(_t(h), _t(head), torch.from_numpy(tgt), chunk=8)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("policy", ["plain", "pallas"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_attn_forward_matches(causal, policy):
    jcfg, cfg = _cfgs("float32")
    p = _np_params(jcfg, 3)["dec"]["layers"]["self_attn"]
    p = {k: v[0] for k, v in p.items()}
    x = np.random.default_rng(4).standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    want = jattn.attn_forward(_jtree(p), jnp.asarray(x), jcfg, POLICIES[policy], causal=causal)
    got = tattn.attn_forward({k: _t(v) for k, v in p.items()}, _t(x), cfg, causal=causal)
    _close(got, want, F32, "attn_forward")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

CASES = [("float32", "plain"), ("float32", "pallas"), ("bfloat16", "plain"), ("bfloat16", "pallas")]


@pytest.mark.parametrize("dtype,policy", CASES)
def test_encode_decode_train_and_loss_match(dtype, policy):
    jcfg, cfg = _cfgs(dtype)
    rel, pol = (F32 if dtype == "float32" else BF16), POLICIES[policy]
    tree = _np_params(jcfg, 5)
    frames, tokens = _inputs(cfg, 6, s=16)
    targets = np.roll(tokens, -1, axis=1)
    jp = _jtree(tree)
    jenc = jax.jit(lambda p, f: jwhisper.encode(p, f, jcfg, pol))(jp, frames)
    jh = jax.jit(lambda p, t, e: jwhisper.decode_train(p, t, e, jcfg, pol))(jp, tokens, jenc)
    batch = {"frames": frames, "tokens": tokens, "targets": targets}
    jloss, _ = jax.jit(lambda p, b: jwhisper.whisper_loss(p, b, jcfg, pol))(jp, batch)
    params = whisper_params_from_numpy(tree, device="cpu")
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens).long()
    enc = twhisper.encode(params, tf, cfg)
    assert enc.dtype == cfg.activation_dtype
    _close(enc, jenc, rel, "encoder states")
    _close(twhisper.decode_train(params, tt, enc, cfg), jh, rel, "decoder hidden states")
    loss, metrics = whisper_loss(
        params, {"frames": tf, "tokens": tt, "targets": torch.from_numpy(targets).long()}, cfg)
    assert loss.dtype == torch.float32 and metrics["xent"] is loss
    _close(loss, jloss, rel, "loss")


@pytest.mark.parametrize("dtype,policy", CASES)
def test_prefill_and_decode_match(dtype, policy):
    """A 9-token prompt into a cache of 14, then 4 greedy decode steps,
    each side on its own cache, the reference's tokens fed to both."""
    jcfg, cfg = _cfgs(dtype)
    rel, pol = (F32 if dtype == "float32" else BF16), POLICIES[policy]
    tree = _np_params(jcfg, 7)
    frames, tokens = _inputs(cfg, 8)
    s, max_len = tokens.shape[1], 14
    jp = _jtree(tree)
    jl, jc = jax.jit(lambda p, t, f: jwhisper.whisper_prefill(p, t, f, jcfg, pol, max_len=max_len))(
        jp, tokens, frames)
    params = whisper_params_from_numpy(tree, device="cpu")
    tl, tc = whisper_prefill(params, torch.from_numpy(tokens).long(), torch.from_numpy(frames), cfg,
                             max_len=max_len)
    _close(tl, jl, rel, "prefill logits")
    pairs = [(tc["self"]["k"], jc["self"]["k"]), (tc["self"]["v"], jc["self"]["v"]),
             (tc["cross_k"], jc["cross_k"]), (tc["cross_v"], jc["cross_v"])]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close(got, want, rel, "prefill cache")
    assert not tc["self"]["k"][:, :, :, s:].any()
    jstep = jax.jit(lambda p, t, c, i: jwhisper.whisper_decode_step(p, t, c, i, jcfg, pol))
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(4):
        jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.int32(s + i))
        tl, tc = whisper_decode_step(params, torch.from_numpy(tok).long(), tc, s + i, cfg)
        _close(tl, jl, rel, f"decode step {i} logits")
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    _close(tc["self"]["k"], jc["self"]["k"], rel, "self cache after 4 steps")
    _close(tc["self"]["v"], jc["self"]["v"], rel, "self cache after 4 steps")


def test_decode_step_gives_the_logits_of_a_longer_prefill():
    """prefill(S - 1) + one decode step == prefill(S): within 2e-3 of
    max|ref| at f32, since the decode step attends over the bf16 cache,
    which the prefill's own attention does not round."""
    _, cfg = _cfgs("float32")
    params = init_whisper_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    frames, tokens = _inputs(cfg, 9, s=11)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens).long()
    full, _ = whisper_prefill(params, tt, tf, cfg)
    _, cache = whisper_prefill(params, tt[:, :-1], tf, cfg, max_len=tt.shape[1])
    step, _ = whisper_decode_step(params, tt[:, -1:], cache, tt.shape[1] - 1, cfg)
    _close(step, full, 2e-3, "decode step vs the longer prefill")


def test_param_carry_and_random_init_match_the_reference_tree():
    jcfg, cfg = _cfgs()
    tree = _np_params(jcfg, 11)
    back = whisper_params_to_numpy(whisper_params_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    want = _paths(_ref_shapes(jcfg))
    masters = init_whisper_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert _paths(masters) == want
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(masters))
    # the serving draw: each leaf cast as drawn, bitwise the cast masters
    served = init_whisper_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu",
                                 serving=True)
    assert _paths(served) == want
    for path in want:
        got, master = served, masters
        for k in path:
            got, master = got[k], master[k]
        keep = path[-1] in ("embed", "w", "b")
        assert got.dtype == (torch.float32 if keep else torch.bfloat16), path
        assert torch.equal(got, master.to(got.dtype)), path
    cache = init_whisper_cache(cfg, 3, 10, device="cpu")
    jcache = jwhisper.init_whisper_cache(jcfg, 3, 10)
    assert _paths(cache) == _paths(jcache)


def test_serving_routes_and_launch_counts(monkeypatch):
    """Flash runs the encoder and every cross-attention (one query row in
    a decode step) and decode_train's self-attention: 2 L a prefill, L a
    decode step, 3 L a loss, counted at the wrapper; no RMSNorm."""
    import repro_torch.kernels.flash_attention as flash_pkg
    import repro_torch.kernels.rmsnorm as rms_pkg

    calls = {"rms": 0, "flash": 0, "sq": []}
    rms, flash = rms_pkg.rmsnorm, flash_pkg.flash_attention

    def counted_flash(q, k, v, **kw):
        calls["flash"] += 1
        calls["sq"].append((q.shape[2], k.shape[2], kw["causal"]))
        return flash(q, k, v, **kw)

    def counted_rms(*a, **kw):
        calls["rms"] += 1
        return rms(*a, **kw)

    monkeypatch.setattr(rms_pkg, "rmsnorm", counted_rms)
    monkeypatch.setattr(flash_pkg, "flash_attention", counted_flash)
    _, cfg = _cfgs()
    params = init_whisper_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    frames, tokens = _inputs(cfg, 12, s=5)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens).long()
    f = cfg.encoder.frames
    logits, cache = whisper_prefill(params, tt, tf, cfg, max_len=8)
    assert calls["flash"] == twhisper.flash_per_prefill(cfg) == 4 and calls["rms"] == 0
    assert calls["sq"] == [(f, f, False)] * 2 + [(5, f, False)] * 2
    whisper_decode_step(params, torch.argmax(logits, -1)[:, None], cache, 5, cfg)
    assert calls["flash"] == 4 + cfg.n_layers and calls["sq"][4:] == [(1, f, False)] * 2
    batch = {"frames": tf, "tokens": tt, "targets": tt}
    whisper_loss(params, batch, cfg)
    assert calls["flash"] == 6 + twhisper.flash_per_loss(cfg) and twhisper.flash_per_loss(cfg) == 6
    assert calls["sq"][6:] == [(f, f, False)] * 2 + [(5, 5, True), (5, f, False)] * 2
    assert calls["rms"] == 0


def test_engine_and_cli_refuse_encdec_in_the_reference_words():
    _, cfg = _cfgs()
    words = "encoder-decoder models go through the whisper_\\* entry points"
    with pytest.raises(ValueError, match=words):
        TransformerRunner(cfg, {}, device="cpu")
    with pytest.raises(ValueError, match=words):
        Engine(cfg, {}, device="cpu")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert ("Encoder-decoder archs are served via the whisper_* entry points" in out.stderr
            and "Queue 1 item 5" not in out.stderr)
