"""The port's distributed LM serving against the JAX package and its own
serial engine, on the CPU.

In this process, against the reference (``src/repro/models/attention.py``,
``transformer.py``): ``init_kv_cache``'s split and int8 leaves,
``quantize_kv`` and ``flush_tail`` on a prefix with room, bitwise; the
split decode step, plain and int8, on a prefix the prompt fills (the one
case the reference's split decode is right for), one layer and through
``lm_decode_step``, for 1 and 60 steps, at f32 1e-4 of max|ref|;
``cache_specs`` of every decoder arch (the tail beside a head-sharded
prefix cut by kv heads, where the reference replicates it); MLA's split
latent cache (``init_mla_cache(split=True)``), unquantised under
``kv_quant``, and its absorbed split decode on a full prefix. The port's
own: its masked split decode, GQA's and MLA's, equals its plain decode on
a prompt shorter than the prefix; MLA's ``flush_tail`` within a chunk;
MLA's latent prefix sharded by sequence at every model group.

Then one launch of 4 gloo ranks runs ``tests/torch_dist_serve_lm_checks.py``
(its docstring lists the checks): ``Engine(policy=)`` on (1 x 4), (2 x 2)
and (4 x 1) against the port's serial ``Engine`` (itself held against the
reference's in ``tests/test_torch_lm.py``), each rank's cache holding 1/P
of the prefix, and ``moe_apply`` over the model group where the
all-to-all's condition fails against the reference's. Gates, stated where
used.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_dist_serve_lm_checks as rank_side
from lm_train_common import StandInGroup, _lm_tree
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.policy import LOCAL as JLOCAL
from repro.models.policy import ParallelPolicy as JPolicy
from repro_torch.configs import ARCH_IDS, ENCDEC_IDS, get_arch, reduced
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import (
    LOCAL, ParallelPolicy, init_cache, init_whisper_cache, lm_decode_step, lm_params_from_numpy,
    lm_prefill,
)
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.policy import ONE_RANK
from torch_dist_checks import one_launch_at_a_time

TIMEOUT_S = 240
F32 = 1e-4          # of max|ref|: the reference's serial gate
BF16 = 3e-2         # of max|ref|: the bf16 gate of tests/test_torch_lm.py
# int8 prefixes: the reference states "~1e-2 relative logit error"
# (src/repro/models/policy.py:45-46); held at 3x that of max|ref|
INT8 = 3e-2
MOE_TOL = (2e-3, 2e-4)   # tests/distributed_checks.py: moe
GRAD_RTOL, GRAD_ATOL_OF_MAX = 5e-3, 1e-3
DECODER_IDS = tuple(a for a in ARCH_IDS if a not in ENCDEC_IDS)
MOE_D = 32


def _cfgs(arch="chatglm3-6b", **changes):
    changes.setdefault("dtype", "float32")
    return tuple(dataclasses.replace(c, **changes)
                 for c in (jreduced(jget_arch(arch)), reduced(get_arch(arch))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _close(got, ref, tol, what=""):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=tol * float(np.abs(ref).max()),
                               err_msg=what)


def _bitwise(got, ref, what):
    got = got.detach()
    ref = np.asarray(ref)
    if got.dtype == torch.bfloat16:
        assert ref.dtype == ml_dtypes.bfloat16, what
        got, ref = got.view(torch.int16).numpy(), ref.view(np.int16)
    else:
        got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape, (what, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=what)


# ---------------------------------------------------------------------------
# the split and int8 caches against the reference, one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,split,quant", [
    ("chatglm3-6b", False, False), ("chatglm3-6b", True, False), ("chatglm3-6b", True, True),
    ("chatglm3-6b", False, True), ("recurrentgemma-2b", True, True),
    ("deepseek-v2-lite-16b", False, False), ("deepseek-v2-lite-16b", True, False),
    ("deepseek-v2-lite-16b", True, True)])
def test_init_kv_cache_leaves_are_the_references(arch, split, quant):
    """``init_kv_cache(split=, quant=)``: the reference's leaves, shapes,
    dtypes and zeros (int8 only on a split cache without a window); under
    MLA ``init_mla_cache(split=)``'s, whose latent no ``quant`` touches."""
    jcfg, cfg = _cfgs(arch)
    if cfg.mla is not None:
        want = jattn.init_mla_cache(jcfg, 3, 40, split=split)
        got = tattn.init_mla_cache(cfg, 3, 40, split=split)
    else:
        want = jattn.init_kv_cache(jcfg, 3, 40, split=split, quant=quant)
        got = tattn.init_kv_cache(cfg, 3, 40, split=split, quant=quant)
    assert sorted(got) == sorted(want)
    for name in want:
        _bitwise(got[name], want[name], name)
    assert {n: sh for n, (sh, _) in tattn.cache_leaves(cfg, 3, 40, None, split=split,
                                                         quant=quant).items()} == {
        n: tuple(a.shape) for n, a in want.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_the_references(dtype):
    """int8 values and bf16 per-token scales bitwise, a zero row included
    (its scale the 1e-8 floor)."""
    x = np.random.default_rng(0).standard_normal((2, 3, 17, 16)).astype(np.float32) * 3
    x[0, 1, 4] = 0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    wq, ws = jattn.quantize_kv(jx)
    q, s = tattn.quantize_kv(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    _bitwise(q, wq, "values")
    _bitwise(s, ws, "scales")


def _split_cache_np(rng, b, kvh, s, hd, dtype=np.float32):
    k, v = (rng.standard_normal((b, kvh, s, hd)).astype(dtype) for _ in range(2))
    tail = [rng.standard_normal((b, kvh, tattn.TAIL_LEN, hd)).astype(dtype) for _ in range(2)]
    return {"k": k, "v": v, "tk": tail[0], "tv": tail[1]}


def test_flush_tail_on_a_prefix_with_room_is_the_references():
    """The whole tail written at the valid prefix length and zeroed, as the
    reference's ``flush_tail``, bitwise (bf16 leaves); and one row at a
    time at per-row lengths, each row's entries where the reference puts
    them for that length."""
    c = _split_cache_np(np.random.default_rng(1), 2, 2, 160, 16)
    jc = {n: jnp.asarray(a, jnp.bfloat16) for n, a in c.items()}
    want = jattn.flush_tail(jc, 37)
    got = tattn.flush_tail({n: _t(a.astype(np.float32)).bfloat16() for n, a in jc.items()}, 37)
    for name in want:
        _bitwise(got[name], want[name], name)
    rows = tattn.flush_tail({n: _t(a.astype(np.float32)).bfloat16() for n, a in jc.items()},
                            [37, 90])
    for r, start in enumerate((37, 90)):
        one = jattn.flush_tail({n: a[r:r + 1] for n, a in jc.items()}, start)
        for name in ("k", "v"):
            _bitwise(rows[name][r:r + 1], one[name], f"row {r} {name}")


def test_flush_tail_into_an_int8_prefix_quantizes_the_tail():
    """The reference's ``flush_tail`` into an int8 prefix raises (its bf16
    tail into an int8 buffer) and would return no scales; the port writes
    the tail quantized by ``quantize_kv``, scales included, at each row's
    length (the second row's tail filling the prefix to its end), and
    leaves the rest of the prefix as it was."""
    c = _split_cache_np(np.random.default_rng(2), 2, 2, 128, 16)
    jc = {n: jnp.asarray(a, jnp.bfloat16) for n, a in c.items()}
    kq, ks = jattn.quantize_kv(jc["k"])
    vq, vs = jattn.quantize_kv(jc["v"])
    jq = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "tk": jc["tk"], "tv": jc["tv"]}
    with pytest.raises(TypeError):
        jattn.flush_tail(jq, 10)
    port = {n: _t(np.asarray(a).astype(np.float32)).to(
        torch.int8 if a.dtype == jnp.int8 else torch.bfloat16) for n, a in jq.items()}
    tail_q = {n: jattn.quantize_kv(jc[t]) for n, t in (("k", "tk"), ("v", "tv"))}
    tattn.flush_tail(port, [10, 64])
    n = tattn.TAIL_LEN
    for r, start in enumerate((10, 64)):
        for name in ("k", "v"):
            values, scales = tail_q[name]
            _bitwise(port[name][r, :, start:start + n], values[r, :, :n], f"{name} row {r}")
            _bitwise(port[name + "_scale"][r, :, start:start + n], scales[r, :, :n], name)
            _bitwise(port[name][r, :, :start], jq[name][r, :, :start], f"{name} before")
            _bitwise(port[name][r, :, start + n:], jq[name][r, :, start + n:], f"{name} past")
    assert not port["tk"].any() and not port["tv"].any()
    with pytest.raises(ValueError, match="overflows a prefix of 128"):
        tattn.flush_tail(port, 65)


def _attn_params(jcfg, seed):
    return jax.device_get(jattn.init_attn_params(jax.random.PRNGKey(seed), jcfg))


def _quantized(cache: dict, quant: bool) -> dict:
    """A reference split cache's prefix as int8 with scales, if ``quant``."""
    if not quant:
        return cache
    out = dict(cache)
    for name in ("k", "v"):
        out[name], out[name + "_scale"] = jattn.quantize_kv(cache[name])
    return out


def _to_port(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy())
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(a.astype(np.float32))
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("steps", [1, 60])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_split_decode_matches_the_reference_on_a_full_prefix(quant, steps):
    """One layer's split decode (``attn_decode`` on a cache with a tail)
    against the reference's under ``LOCAL``, its prefix full (S = the
    tokens before the first step), bf16 prefix or int8 with scales, bf16
    tail, f32 activations: every step's output within 1e-4 of max|ref|,
    and the tail as the reference's."""
    jcfg, cfg = _cfgs(qkv_bias=True)
    p_np = _attn_params(jcfg, 3)
    p_np = {k: (v + 0.1 * np.random.default_rng(4).standard_normal(v.shape)).astype(np.float32)
            for k, v in p_np.items()}
    rng = np.random.default_rng(5)
    b, s = 2, 24
    c = _split_cache_np(rng, b, cfg.kv_heads, s, cfg.head_dim_)
    c["tk"][:] = 0
    c["tv"][:] = 0
    jc = _quantized({n: jnp.asarray(a, jnp.bfloat16) for n, a in c.items()}, quant)
    tc = _to_port(jc)
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    jp = jax.tree.map(jnp.asarray, p_np)
    jstep = jax.jit(lambda p, x, c, i: jattn.attn_decode(p, x, c, i, jcfg, JLOCAL))
    for i in range(steps):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        want, jc = jstep(jp, jnp.asarray(x), jc, jnp.int32(s + i))
        got, tc = tattn.attn_decode(p, torch.from_numpy(x), tc, torch.full((b,), s + i), cfg)
        _close(got, want, F32, f"step {i}")
    for name in ("tk", "tv"):
        _bitwise(tc[name], jc[name], name)


def _prefilled(jcfg, cfg, tree, tokens, quant):
    """The reference's prefill cache (LOCAL, max_len = the prompt) made
    split: f32 prefix (int8 with scales under ``quant``) and f32 tail; the
    same leaves as the port's tree."""
    jp = jax.tree.map(jnp.asarray, tree)
    logits, cache = jtf.lm_prefill(jp, jnp.asarray(tokens), jcfg, JLOCAL)
    layers_ = dict(cache["layers"])
    zeros = jnp.zeros(layers_["k"].shape[:3] + (tattn.TAIL_LEN,) + layers_["k"].shape[4:])
    layers_.update(tk=zeros, tv=zeros)
    return jp, logits, {"layer0": None, "layers": _quantized(layers_, quant)}


@pytest.mark.parametrize("steps", [1, 60])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_split_lm_decode_step_matches_the_reference_on_a_full_prefix(quant, steps):
    """``lm_decode_step`` on a split cache (the reference's prefill of the
    prompt, the prefix the prompt's length) against the reference's under
    ``LOCAL``: greedy tokens fed on both sides, every step's logits within
    1e-4 of max|ref|."""
    jcfg, cfg = _cfgs()
    tree = _lm_tree(jcfg, 7)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jp, logits, jc = _prefilled(jcfg, cfg, tree, tokens, quant)
    params, tc = lm_params_from_numpy(tree, device="cpu"), _to_port(jc)
    tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
    jstep = jax.jit(lambda p, t, c, i: jtf.lm_decode_step(p, t, c, i, jcfg, JLOCAL))
    for i in range(steps):
        want, jc = jstep(jp, jnp.asarray(tok), jc, jnp.int32(9 + i))
        got, tc = lm_decode_step(params, torch.from_numpy(tok).long(), tc, 9 + i, cfg)
        _close(got, want, F32, f"step {i}")
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)


def _one_rank(**kw):
    return ParallelPolicy(mesh={"data": ONE_RANK, "model": ONE_RANK}, **kw)


def test_masked_split_decode_equals_plain_decode_on_a_short_prompt():
    """A prompt of 5 tokens in a prefix of 96, 70 greedy steps, the tail
    flushed after 64 (``flush_tails``): the port's split decode (each row
    masked to its valid prefix and tail) against its plain decode, f32
    caches, logits within 1e-5 of max|ref| and tokens equal. The reference
    attends over the whole prefix and writes the tail at slot index - S,
    clamped to 0: on reduced chatglm3-6b, one layer, a 5-token prompt in a
    prefix of 16, its split decode's logits sit 0.70 of max|plain| from its
    plain decode's (2.0e-7 with the prefix exactly the prompt). A step whose
    row is not within ``TAIL_LEN`` of its prefix length is refused."""
    _masked_split_against_plain("chatglm3-6b")


def test_masked_split_mla_decode_equals_plain_decode_on_a_short_prompt():
    """MLA's absorbed split decode (``_mla_decode_split``, P = 1: a 5-token
    prompt in a prefix of 96, the tail ``tckv``/``tkr`` flushed after 64)
    against the port's plain ``mla_decode``, as the GQA test above: f32
    caches, logits within 1e-5 of max|ref| over 70 steps, tokens equal. The
    reference's split branch has the same fault as its GQA one (no mask on
    the prefix, the tail slot clamped; ``test_reference_mla_split_decode_
    is_wrong_on_a_short_prompt``)."""
    _masked_split_against_plain("deepseek-v2-lite-16b")


def _masked_split_against_plain(arch):
    _, cfg = _cfgs(arch)
    tree = _lm_tree(_cfgs(arch)[0], 9)
    params = lm_params_from_numpy(tree, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(10).integers(0, cfg.vocab, (2, 5))).long()
    pol = _one_rank()
    plain = init_cache(cfg, 2, 96, torch.float32, device="cpu")
    split = init_cache(cfg, 2, 96, torch.float32, device="cpu", policy=pol)
    tail = "tckv" if cfg.mla is not None else "tk"
    assert tail in split["layers"] and tail not in plain["layers"]
    want, _ = lm_prefill(params, tokens, cfg, cache=plain)
    got, _ = lm_prefill(params, tokens, cfg, cache=split, policy=pol)
    _close(got, want, 1e-5, "prefill")
    tok, plen, flushed = want.argmax(-1)[:, None], [5, 5], 0
    for i in range(70):
        if 5 + i - plen[0] == tattn.TAIL_LEN:
            for r in range(2):
                ttf.flush_tails(split, cfg, r, plen[r], policy=pol)
            plen, flushed = [n + tattn.TAIL_LEN for n in plen], flushed + 1
        want, _ = lm_decode_step(params, tok, plain, 5 + i, cfg)
        if i == 3:  # the reference's assumption, the whole prefix valid
            with pytest.raises(ValueError, match="flush its tail"):
                lm_decode_step(params, tok, split, 5 + i, cfg, policy=pol)
        got, _ = lm_decode_step(params, tok, split, 5 + i, cfg, policy=pol, prefix_len=plen)
        _close(got, want, 1e-5, f"step {i}")
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        tok = want.argmax(-1)[:, None]
    assert flushed == 1


def _mla_layer(seed):
    """Reduced deepseek-v2-lite-16b (f32) and one MLA layer's reference
    parameters."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    return jcfg, cfg, jax.device_get(jattn.init_mla_params(jax.random.PRNGKey(seed), jcfg))


def _mla_split_np(cache, prefix, tail=None):
    """A reference split MLA cache (numpy f32): ``cache``'s ckv and kr cut
    or zero-padded to ``prefix`` positions, and a tail (zeros by default)."""
    out = {}
    for name, t in (("ckv", "tckv"), ("kr", "tkr")):
        a = np.zeros(cache[name].shape[:1] + (prefix,) + cache[name].shape[2:], np.float32)
        n = min(prefix, cache[name].shape[1])
        a[:, :n] = cache[name][:, :n]
        out[name] = a
        out[t] = (np.zeros(a.shape[:1] + (tattn.TAIL_LEN,) + a.shape[2:], np.float32)
                  if tail is None else tail[t])
    return out


def test_reference_mla_split_decode_is_wrong_on_a_short_prompt():
    """The reference fault the port does not copy (ROADMAP Queue 3): the
    reference's ``mla_decode`` split branch attends over every prefix
    position and writes the new token at tail slot index - S, which clamps
    to 0 and is then masked, until the prompt fills the prefix. Reduced
    deepseek-v2-lite-16b, one layer, f32 caches, a 5-token prompt, the
    first decode step: against its plain branch the split branch's output
    sits 0.67 of max|plain| away with a prefix of 16 (6.718e-01), and
    1.9e-7 away with the prefix exactly the prompt."""
    jcfg, _, p_np = _mla_layer(11)
    rng = np.random.default_rng(12)
    prompt = jnp.asarray(rng.standard_normal((2, 5, jcfg.d_model)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)), jnp.float32)
    p = jax.tree.map(jnp.asarray, p_np)
    _, _, ckv, kr = jattn._mla_qkr(p, prompt, jcfg, jnp.arange(5))
    prompt_cache = {"ckv": np.asarray(ckv), "kr": np.asarray(kr)}
    plain = {n: jnp.asarray(a) for n, a in _mla_split_np(prompt_cache, 16).items()
             if n in ("ckv", "kr")}
    want = np.asarray(jattn.mla_decode(p, x, plain, 5, jcfg)[0])

    def rel(prefix):
        split = {n: jnp.asarray(a) for n, a in _mla_split_np(prompt_cache, prefix).items()}
        got = np.asarray(jattn.mla_decode(p, x, split, 5, jcfg)[0])
        return float(np.abs(got - want).max() / np.abs(want).max())

    assert rel(16) > 0.5 and rel(5) < 1e-6


@pytest.mark.parametrize("steps", [1, 60])
def test_split_mla_decode_matches_the_reference_on_a_full_prefix(steps):
    """One layer's absorbed split decode (``mla_decode`` on a cache with
    ``tckv``, P = 1) against the reference's split branch under ``LOCAL``,
    its prefix full (the 24 positions before the first step, random
    latents), f32 caches and activations: every step's output within 1e-4
    of max|ref|, and the tail as the reference's."""
    jcfg, cfg, p_np = _mla_layer(13)
    rng = np.random.default_rng(14)
    b, s = 2, 24
    full = {"ckv": rng.standard_normal((b, s, cfg.mla.kv_lora)).astype(np.float32),
            "kr": rng.standard_normal((b, s, cfg.mla.dh_rope)).astype(np.float32)}
    c = _mla_split_np(full, s)
    jc = {n: jnp.asarray(a) for n, a in c.items()}
    tc = {n: torch.from_numpy(a.copy()) for n, a in c.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_np.items()}
    jp = jax.tree.map(jnp.asarray, p_np)
    jstep = jax.jit(lambda p, x, c, i: jattn.mla_decode(p, x, c, i, jcfg, JLOCAL))
    for i in range(steps):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        want, jc = jstep(jp, jnp.asarray(x), jc, jnp.int32(s + i))
        got, tc = tattn.mla_decode(p, torch.from_numpy(x), tc, torch.full((b,), s + i), cfg)
        _close(got, want, F32, f"step {i}")
    for name in ("tckv", "tkr"):
        _close(tc[name], jc[name], F32, name)


def test_mla_flush_tail_writes_each_row_within_its_chunk():
    """MLA's ``flush_tail`` (tckv into ckv, tkr into kr along positions):
    on the whole prefix (chunk (0, 1)) each row's tail lands at its
    ``prefix_valid`` and the rest stays; on chunk m of a sequence-sharded
    prefix only the positions of that chunk are written, the chunk of the
    whole prefix's flush, whichever part of a row's tail falls in it (none,
    some, all). The tails are zeroed."""
    rng = np.random.default_rng(15)
    b, t, s, p = 3, tattn.TAIL_LEN, 192, 2

    def cache(n):
        return {name: torch.from_numpy(rng.standard_normal((b, n, w)).astype(np.float32))
                for name, w in (("ckv", 32), ("kr", 8))}

    prefix = cache(s)
    tails = {"t" + k: v for k, v in cache(t).items()}
    starts = [10, 60, 120]  # all in chunk 0; across the chunks; all in chunk 1
    want = {k: v.clone() for k, v in prefix.items()}
    for r, start in enumerate(starts):
        for name in ("ckv", "kr"):
            want[name][r, start:start + t] = tails["t" + name][r]
    whole = tattn.flush_tail({**{k: v.clone() for k, v in prefix.items()},
                              **{k: v.clone() for k, v in tails.items()}}, starts)
    for name in want:
        assert torch.equal(whole[name], want[name]), name
    for m in range(p):
        part = {**{k: v[:, m * s // p:(m + 1) * s // p].clone() for k, v in prefix.items()},
                **{k: v.clone() for k, v in tails.items()}}
        tattn.flush_tail(part, starts, chunk=(m, p))
        for name in want:
            assert torch.equal(part[name], want[name][:, m * s // p:(m + 1) * s // p]), (m, name)
        assert not part["tckv"].any() and not part["tkr"].any()
    with pytest.raises(ValueError, match="overflows a prefix of 192"):
        tattn.flush_tail({**cache(s // p), **tails}, 129, chunk=(1, p))


def test_mla_prefix_is_sharded_by_sequence_at_every_model_group():
    """MLA's latent has no heads: its prefix is sharded by sequence at
    every P > 1 (the reference's ``cache_specs``), for reduced
    deepseek-v2-lite-16b (2 kv heads, which 2 divides) and the full config
    (16, which 2 and 4 divide) alike; GQA's rule still asks whether P
    divides the kv heads."""
    def pol(n):
        return ParallelPolicy(mesh={"data": StandInGroup(1), "model": StandInGroup(n)})

    for cfg in (reduced(get_arch("deepseek-v2-lite-16b")), get_arch("deepseek-v2-lite-16b")):
        assert cfg.kv_heads % 2 == 0
        assert not tattn.prefix_by_sequence(cfg, pol(1))
        assert tattn.prefix_by_sequence(cfg, pol(2)) and tattn.prefix_by_sequence(cfg, pol(4))
        assert ttf._chunk(cfg, pol(4)) == (0, 4)
    gqa = reduced(get_arch("chatglm3-6b"))
    assert not tattn.prefix_by_sequence(gqa, pol(2)) and tattn.prefix_by_sequence(gqa, pol(4))


def test_kv_quant_leaves_the_mla_cache_unquantised():
    """``kv_quant`` int8-quantizes a split GQA prefix but leaves MLA's
    latent cache in the cache dtype with no scales, as the reference's
    ``mla_spec`` has none: the same leaves as without it, cut by sequence
    over 2 model ranks."""
    cfg = reduced(get_arch("deepseek-v2-lite-16b"))
    mesh = {"data": StandInGroup(1), "model": StandInGroup(2)}
    quant = init_cache(cfg, 2, 16, device="cpu", policy=ParallelPolicy(mesh=mesh, kv_quant=True))
    plain = init_cache(cfg, 2, 16, device="cpu", policy=ParallelPolicy(mesh=mesh))
    for key in ("layer0", "layers"):
        assert sorted(quant[key]) == ["ckv", "kr", "tckv", "tkr"]
        for name, t in quant[key].items():
            assert t.dtype == torch.bfloat16 and t.shape == plain[key][name].shape, (key, name)
    assert quant["layers"]["ckv"].shape == (1, 2, 8, cfg.mla.kv_lora)


def _as_tuples(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return tuple(tree)


def _tail_by_heads(spec):
    """The reference's cache spec tree with each split tail cut as its
    prefix is where the prefix is cut by kv heads: the port's one
    difference. The reference replicates the tail there; the port's rank
    decodes over its kv heads alone and keeps theirs."""
    if isinstance(spec, list):
        return [_tail_by_heads(s) for s in spec]
    if not isinstance(spec, dict):
        return spec
    if "tk" in spec and "model" in spec["k"] and spec["k"].index("model") == len(spec["k"]) - 3:
        return {**spec, "tk": spec["k"], "tv": spec["v"]}
    return {k: _tail_by_heads(v) for k, v in spec.items()}


def _rec_cache_whole(spec):
    """The reference's cache spec tree with each RG-LRU cache ({"conv",
    "h"}) whole over the model axis: the port's second difference. The
    reference cuts that cache by width where P divides it while it
    replicates the mixer that fills it; the port keeps it whole, as the
    mixer's leaves, so that a decode step needs no collective for it."""
    if isinstance(spec, list):
        return [_rec_cache_whole(s) for s in spec]
    if not isinstance(spec, dict):
        return spec
    if sorted(spec) == ["conv", "h"]:
        return {k: tuple(None if e == "model" else e for e in v) for k, v in spec.items()}
    return {k: _rec_cache_whole(v) for k, v in spec.items()}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("model", [1, 2, 4, 16])
def test_cache_specs_are_the_references_for_every_arch(model, quant):
    """``cache_specs`` of every decoder arch equals the reference's (each
    PartitionSpec as the tuple of its entries) through a stand-in mesh, at
    model axes that divide the kv heads and that do not, with and without
    ``kv_quant``, but for the tail beside a head-sharded prefix, which the
    port cuts by kv heads (``_tail_by_heads``), and the RG-LRU's cache,
    which it keeps whole (``_rec_cache_whole``); and a one-device policy's
    (no split) too."""
    jpol = JPolicy(mesh=types.SimpleNamespace(shape={"data": 1, "model": model}), kv_quant=quant)
    pol = ParallelPolicy(mesh={"data": StandInGroup(1), "model": StandInGroup(model)},
                         kv_quant=quant)
    assert set(DECODER_IDS) <= set(JARCH_IDS)
    for arch in DECODER_IDS:
        assert ttf.cache_specs(get_arch(arch), pol) == _rec_cache_whole(_tail_by_heads(
            _as_tuples(jtf.cache_specs(jget_arch(arch), jpol)))), arch
        if model == 1:
            assert ttf.cache_specs(get_arch(arch), LOCAL) == _rec_cache_whole(_as_tuples(
                jtf.cache_specs(jget_arch(arch), JLOCAL))), arch


def test_serving_over_a_mesh_refuses_what_is_not_ported():
    """The SSM and hybrid families are served over a model group: a rank's
    cache holds its SSM heads' state, its chunk of the local attention's
    ring and the RG-LRU's cache whole. The encoder-decoder family is
    served over a model group too: a rank's caches hold its kv heads
    (``tests/test_torch_dist_whisper.py`` serves it). SSM heads and a ring that
    the model group does not divide, MLA heads that it does not divide, a
    split cache's prefix that it does not divide, and slots that the data
    group does not, are refused by name; MLA takes its split cache on a
    data-only mesh too."""
    two = ParallelPolicy(mesh={"data": StandInGroup(1), "model": StandInGroup(2)})
    ssm, hybrid = reduced(get_arch("mamba2-370m")), reduced(get_arch("recurrentgemma-2b"))
    state = init_cache(ssm, 2, 16, device="cpu", policy=two)["layers"]["state"]
    assert state.shape[2] == ssm.ssm.n_heads(ssm.d_model) // 2
    cache = init_cache(hybrid, 2, 40, device="cpu", policy=two)["superblocks"]
    assert cache["b2_attn"]["k"].shape[3] == hybrid.window // 2
    assert cache["b0_rec"]["h"].shape[-1] == hybrid.rglru.width(hybrid.d_model)
    whisper = reduced(get_arch("whisper-tiny"))
    assert ttf.check_mesh_arch(whisper, two) is None
    assert init_whisper_cache(whisper, 2, 16, device="cpu", policy=two)["cross_k"].shape == (
        whisper.n_layers, 2, 1, whisper.encoder.frames, whisper.head_dim_)
    three = ParallelPolicy(mesh={"data": StandInGroup(1), "model": StandInGroup(3)})
    with pytest.raises(ValueError, match="8 SSM heads do not split over 3 model ranks"):
        init_cache(ssm, 2, 16, device="cpu", policy=three)
    with pytest.raises(ValueError, match="8 SSM heads do not split over 3 model ranks"):
        lm_prefill({}, torch.zeros(1, 4, dtype=torch.long), ssm, policy=three)
    with pytest.raises(ValueError, match="8 SSM heads do not split over 3 model ranks"):
        lm_decode_step({}, torch.zeros(1, 1, dtype=torch.long), {}, 0, ssm, policy=three)
    with pytest.raises(ValueError, match="a local-attention ring of 15 slots does not split "
                                         "over 2 model ranks"):
        init_cache(hybrid, 2, 15, device="cpu", policy=two)
    with pytest.raises(ValueError, match="a local-attention ring of 16 slots does not split "
                                         "over 3 model ranks"):
        init_cache(hybrid, 2, 40, device="cpu", policy=three)
    mla = reduced(get_arch("deepseek-v2-lite-16b"))
    assert "tckv" in init_cache(mla, 2, 16, device="cpu", policy=_one_rank())["layers"]
    assert "tckv" in init_cache(mla, 2, 16, device="cpu", policy=two)["layers"]
    three = ParallelPolicy(mesh={"data": StandInGroup(1), "model": StandInGroup(3)})
    with pytest.raises(ValueError, match="4 MLA heads do not split over 3 model ranks"):
        init_cache(mla, 2, 24, device="cpu", policy=three)
    four = ParallelPolicy(mesh={"data": StandInGroup(2), "model": StandInGroup(4)})
    with pytest.raises(ValueError, match="do not split over 4 model ranks"):
        init_cache(reduced(get_arch("chatglm3-6b")), 2, 18, device="cpu", policy=four)
    with pytest.raises(ValueError, match="do not split over 2 data ranks"):
        init_cache(reduced(get_arch("chatglm3-6b")), 3, 16, device="cpu", policy=four)


# ---------------------------------------------------------------------------
# the ranks: Engine over (data x model), the MoE over the model group
# ---------------------------------------------------------------------------

def _jcfg(arch):
    name = {"gqa": "chatglm3-6b", "mha": "gemma-7b", "moe": "deepseek-moe-16b",
            "mla": "deepseek-v2-lite-16b"}[arch]
    jcfg = dataclasses.replace(jreduced(jget_arch(name)), dtype="float32")
    return dataclasses.replace(jcfg, kv_heads=jcfg.n_heads) if arch == "mha" else jcfg


def _moe_cfg():
    # capacity factor 0.5: the global capacity of a few hundred tokens drops
    # entries (at 1.25 random routes stay under it)
    return dict(n_experts=8, top_k=2, d_expert=16, n_shared=1, capacity_factor=0.5)


def _inputs():
    rng = np.random.default_rng(0)
    inp = {"params": {a: _lm_tree(_jcfg(a), 20 + i) for i, a in enumerate(rank_side.ARCHS)},
           "moe_cfg": _moe_cfg(),
           "moe_params": jax.device_get(jmoe.init_moe_params(
               jax.random.PRNGKey(1), MOE_D, jmoe.MoEConfig(**_moe_cfg())))}
    for name, (_, b, s) in rank_side.MOE_RUNS.items():
        for what in ("x", "cot"):
            inp[f"moe_{what} {name}"] = rng.standard_normal((b, s, MOE_D)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_serve_lm")
    inp = _inputs()
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_checks, 4, str(root), args=(inp,),
                             deadline_s=TIMEOUT_S, device="cpu")
    serial = {}
    for arch, cache_dtype in sorted({(a, c) for a, _, _, c in rank_side.ENGINE_RUNS}):
        params = lm_params_from_numpy(inp["params"][arch], device="cpu")
        serial[arch, cache_dtype] = rank_side.serve(rank_side.arch_cfg(arch), params, LOCAL,
                                                    cache_dtype)
    return {"inp": inp, "ranks": ranks, "serial": serial}


@pytest.mark.parametrize("arch,layout,quant,cache", rank_side.ENGINE_RUNS,
                         ids=[f"{a}-{lay}-{'int8' if q else c}"
                              for a, lay, q, c in rank_side.ENGINE_RUNS])
def test_engine_over_the_mesh_matches_the_serial_engine(run, arch, layout, quant, cache):
    """``Engine(policy=)`` serving 6 requests on 4 slots (one decoding past
    a tail flush) against the port's serial ``Engine`` on the same
    parameters and cache dtype. f32 caches: greedy tokens equal, every
    prefill's and decode step's logits within 1e-4 of max|ref|. The
    reference's bf16 caches: the split decode rounds its unnormalised
    softmax weights to bf16 where the plain decode rounds normalised ones
    (the reference's two arithmetics), so the logits are held at the bf16
    gate, 3e-2 of max|ref|, on every step up to the first greedy token that
    differs, if one does. int8 prefixes against f32 caches: at 3e-2 the
    same way. Exactly one flush, on every rank."""
    key = (arch, layout, quant, cache)
    want = run["serial"][arch, cache]
    got = run["ranks"][0]["engine"][key]
    assert sorted(got["tokens"]) == sorted(want["tokens"])
    assert all(r["engine"][key]["flushes"] == 1 for r in run["ranks"])
    exact = cache == "float32" and not quant
    if exact:
        assert got["tokens"] == want["tokens"]
        assert got["active"] == want["active"]
    prefilled = {}
    for r in run["ranks"]:
        prefilled.update(r["engine"][key]["prefill"])
    assert sorted(prefilled) == sorted(want["prefill"])
    for rid, logits in prefilled.items():
        _close(logits, want["prefill"][rid], F32, f"prefill {rid}")
    tol = F32 if exact else (INT8 if quant else BF16)
    for i, (g, w, active) in enumerate(zip(got["decode"], want["decode"], want["active"])):
        _close(g[active], w[active], tol, f"decode step {i}")
        if not torch.equal(g[active].argmax(-1), w[active].argmax(-1)):
            assert not exact
            break  # the next step's inputs differ


def _check_latents(run, layout):
    """MLA's final latent prefixes, each rank's chunk of the positions put
    together: each slot's valid prefix (its last request's prompt, and
    ``TAIL_LEN`` more for each flush) within 1e-5 of max|ref| of the serial
    Engine's cache there, every position past it zero (the prefill's
    zeros; the tail's entries are not in the prefix). A slot idle after its
    last request is held from position 1: the serial decode step writes
    an idle row's latent at its index 0 (the split one into its tail)."""
    got = run["ranks"][0]["engine"]["mla", layout, False, "float32"]
    want = run["serial"]["mla", "float32"]
    assert got["admitted"] == want["admitted"]
    for slot, rid in got["admitted"].items():
        prompt, max_tokens = rank_side.REQUESTS[rid]
        n = prompt + tattn.TAIL_LEN * max(0, (max_tokens - 2) // tattn.TAIL_LEN)
        lo = 0 if slot in want["active"][-1] else 1
        for name in ("ckv", "kr"):
            g, w = got["latents"][name][:, slot], want["latents"][name][:, slot]
            _close(g[:, lo:n], w[:, lo:n], 1e-5, f"{layout} slot {slot} {name}")
            assert not g[:, n:].any(), (layout, slot, name)


@pytest.mark.parametrize("layout", list(rank_side.LAYOUTS))
def test_each_rank_holds_its_part_of_the_cache(run, layout):
    """A rank's prefix leaves hold 1/P of the serial cache's sequence x
    kv heads (by heads where P divides them, else by sequence) for 1/D of
    the slots; its tail whole beside a sequence-sharded prefix, its kv
    heads beside a head-sharded one. MLA's latent prefix by sequence at
    every P, its tail whole, and each rank's chunk holding the serial
    cache's positions of it (``_check_latents``)."""
    p = rank_side.LAYOUTS[layout]
    d = 4 // p
    for arch in rank_side.ARCHS:
        cfg = rank_side.arch_cfg(arch)
        whole = ttf.init_cache(cfg, rank_side.SLOTS, rank_side.MAX_LEN, device="meta")["layers"]
        by_seq = p > 1 and cfg.kv_heads % p
        for r, rank in enumerate(run["ranks"]):
            shapes = rank["engine"][arch, layout, False, "float32"]["shapes"]
            if cfg.mla is not None:
                for name, tail in (("ckv", "tckv"), ("kr", "tkr")):
                    L, b, s, w = whole[name].shape
                    assert shapes[name] == (L, b // d, s // p, w), (arch, layout, r, name)
                    assert shapes[tail] == (L, b // d, tattn.TAIL_LEN, w), (arch, layout, r, tail)
                continue
            for name in ("k", "v"):
                n, (L, b, kvh, s, hd) = np.prod(shapes[name]), whole[name].shape
                assert n * p * d == L * b * kvh * s * hd, (arch, layout, r, name)
                assert shapes[name] == (L, b // d, kvh // (1 if by_seq else p),
                                        s // (p if by_seq else 1), hd)
            assert shapes["tk"] == (L, b // d, kvh // (1 if by_seq else p), tattn.TAIL_LEN, hd)
    _check_latents(run, layout)


def _jax_moe(inp, name):
    """The reference's ``moe_apply`` under ``LOCAL`` on the whole batch:
    y, aux and the gradients of sum(y * cot) + aux (training), or y alone
    on a decode batch (one token a row: its capacity holds every entry)."""
    moe = jmoe.MoEConfig(**inp["moe_cfg"])
    params = jax.tree.map(jnp.asarray, inp["moe_params"])
    x = jnp.asarray(inp[f"moe_x {name}"])
    if rank_side.MOE_RUNS[name][2] == 1:
        y, aux = jmoe.moe_apply(params, x, moe, JLOCAL)
        return {"y": np.asarray(y), "aux": np.asarray(aux)}
    cot = jnp.asarray(inp[f"moe_cot {name}"])

    def f(p, x):
        y, aux = jmoe.moe_apply(p, x, moe, JLOCAL)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, x)
    flat = {k: v for k, v in gp.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in gp["shared"].items()})
    return {"y": np.asarray(y), "aux": np.asarray(aux), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in flat.items()}}


@pytest.mark.parametrize("name", list(rank_side.MOE_RUNS))
def test_moe_over_the_model_group_without_the_all_to_all(run, name):
    """Routed experts over the model group where the all-to-all's
    condition fails (the reference's ``_moe_local``): every rank of a model
    group routes its data rank's tokens, runs its E/P experts and the group
    sums the parts; the data ranks route as one batch (the global capacity,
    with drops at capacity factor 0.5). Against the reference's ``moe_apply`` on the whole
    batch: y and aux at tests/distributed_checks.py's moe tolerance, and
    on a sequence that P does not divide every gradient at rtol 5e-3 with
    an atol of 1e-3 of the leaf's max|ref|, refusing zeros."""
    inp, got = run["inp"], run["ranks"][0]["moe"][name]
    layout, b, s = rank_side.MOE_RUNS[name]
    assert s % rank_side.LAYOUTS[layout]
    ref = _jax_moe(inp, name)
    np.testing.assert_allclose(_np(got["y"]), ref["y"], rtol=MOE_TOL[0], atol=MOE_TOL[1])
    np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]), rtol=1e-3)
    moe = tmoe.MoEConfig(**inp["moe_cfg"])
    x = torch.from_numpy(inp[f"moe_x {name}"]).reshape(-1, MOE_D)
    topi, _, _ = tmoe._route(x, torch.from_numpy(np.array(inp["moe_params"]["router"])), moe)
    keep = tmoe._dispatch(x, topi, tmoe._capacity(b * s, moe), moe.n_experts)[3]
    assert bool(keep.all()) == (s == 1), "a training batch must drop, a decode batch must not"
    if s == 1:
        return
    for k, g in got["grads"].items():
        scale = float(np.abs(ref[k]).max())
        assert scale == 0.0 or float(g.abs().max()) > 0, k
        np.testing.assert_allclose(_np(g), ref[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * scale, err_msg=k)
