"""Helpers of the LM training tests (``test_torch_lm_train*.py``): the port
against the JAX reference on the CPU.

Both sides get the same parameters (drawn with numpy and carried across
with ``lm_params_from_numpy``) and the same tokens (numpy). The reference
trains under ``LOCAL`` (its plain RMSNorm and attention, which its
training differentiates); the port's wrappers run their plain versions on
CPU tensors. Gates (``check_lm_loss``): with ``dtype="float32"`` the loss,
its cross-entropy and its load-balance term within 1e-5 relative, every
leaf's gradient within 1e-4 of that leaf's max|ref| (sums in another
order). At bf16 the loss within 3e-2, and each leaf's gradient within
3e-2 of its max|ref| or twice the reference's own bf16 error on it (its
bf16 gradient against its f32 gradient on the same params, tokens and
routes), the larger: bf16 rounds every activation, in another order on
each side, and the reference's own bf16 gradients sit 1.5-4.8% of max|ref|
from its f32 ones on these reduced configs. The MoE configs at bf16 run
the reference's bf16 routes on all three runs: a rounding flip of one
token's top-k choice moves that token's whole gradient (``chip_smoke.py``
holds the served MoE logits the same way on the card). Every gradient
gate refuses a leaf that is all zeros or that the port left without a
gradient where the reference's is not zero.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models import whisper as jwhisper
from repro.models.policy import LOCAL as JLOCAL
from repro_torch.configs import ARCH_IDS, ENCDEC_IDS, get_arch, reduced
from repro_torch.models import LOCAL, lm_loss, lm_params_from_numpy, whisper_loss
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

DECODER_IDS = tuple(a for a in ARCH_IDS if a not in ENCDEC_IDS)
LOSS_RTOL, F32_GRAD, BF16 = 1e-5, 1e-4, 3e-2
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "kv_norm", "norm_w", "D", "w")
BIASES = ("bq", "bk", "bv", "b1", "b2", "b", "b_r", "b_i", "conv_b", "conv_bx", "conv_bB", "conv_bC")
SEQ = 32


def cfgs(arch, dtype):
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    return tuple(dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))


def _draw(rng, name, shape):
    """A leaf of ``shape`` for ``name``: fan-in scaled weights, norms and D
    near 1, the reference's ranges for the decay parameters, small
    non-zero biases."""
    def normal(scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if name in NORMS:
        return (1 + normal(0.1)).astype(np.float32)
    if name in BIASES:
        return normal(0.1)
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if name == "dt_bias":
        return np.log(np.expm1(rng.uniform(0.001, 0.1, shape))).astype(np.float32)
    if name == "lambda":
        return np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, shape)))).astype(np.float32)
    if name.startswith("conv"):
        return normal(0.3)
    return normal((shape[-1] if name == "embed" else shape[-2]) ** -0.5)


def _np_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def walk(tree, name=None):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return _draw(rng, name, tuple(tree.shape))

    return walk(shapes)


def _lm_tree(jcfg, seed):
    return _np_tree(jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg)), seed)


def _batch(vocab, b, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jbatch(tokens, targets):
    return {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}


def _tbatch(tokens, targets):
    return {"tokens": torch.from_numpy(tokens).long(), "targets": torch.from_numpy(targets).long()}


def _leaf_pairs(ref, got, prefix=""):
    """(name, reference leaf, port leaf) over the reference's tree (None an
    empty subtree, lists by index)."""
    if ref is None:
        return []
    if isinstance(ref, dict):
        return [t for k in ref for t in _leaf_pairs(ref[k], got[k], f"{prefix}.{k}")]
    if isinstance(ref, list):
        return [t for i, (r, g) in enumerate(zip(ref, got)) for t in _leaf_pairs(r, g, f"{prefix}.{i}")]
    return [(prefix, ref, got)]


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _grads_close(jgrads, tgrads, rel, what, f32_grads=None):
    """Every leaf of the port's gradient tree (tensors, or None where it
    got none) within ``rel`` x max|ref| of the reference's (with
    ``f32_grads``, the reference's f32 gradients, within twice the
    reference's own distance to them where that is larger); an all-zero
    leaf and a missing one whose reference is not zero fail."""
    pairs = _leaf_pairs(jgrads, tgrads)
    own = {name: 2 * float(np.abs(_np32(j) - _np32(f)).max())
           for name, j, f in _leaf_pairs(jgrads, f32_grads)} if f32_grads is not None else {}
    scales = {name: float(np.abs(_np32(j)).max()) for name, j, _ in pairs}
    assert pairs
    for name, j, t in pairs:
        ref = _np32(j)
        # a key bias shifts every logit of a query by the same q . bk, which
        # the softmax cancels: its exact gradient is zero, and both sides'
        # are rounding noise, held at the scale of the query bias's gradient
        scale = scales[name[:-2] + "bq"] if name.endswith(".bk") else scales[name]
        assert t is not None or scale == 0.0, f"{what}{name}: no gradient, max|ref|={scale:.3e}"
        got = t.detach().float().numpy()
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        assert np.isfinite(got).all(), f"{what}{name}: not finite"
        assert np.abs(got).max() > 0, f"{what}{name}: all zeros"
        err, gate = float(np.abs(got - ref).max()), max(rel * scale, own.get(name, 0.0))
        assert err <= gate, (f"{what}{name}: max|d|={err:.3e} > {gate:.3e} ({rel} x "
                             f"max|ref|={scale:.3e}, twice the reference's own bf16 error "
                             f"{own.get(name, 0.0):.3e})")


def _requires_grad(params):
    return ttf._tree_map(lambda t, _: t.requires_grad_(), params)


def _port_grads(params):
    return ttf._tree_map(lambda t, _: t.grad, params)


def _jax_loss_and_grads(jcfg, tree, jb):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jtf.lm_loss(p, b, jcfg, JLOCAL), has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, tree), jb)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_loss_and_grads(cfg, tree, tb, policy=LOCAL):
    params = _requires_grad(lm_params_from_numpy(tree, device="cpu"))
    loss, metrics = lm_loss(params, tb, cfg, policy)
    loss.backward()
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, _port_grads(params)


def _reference_routes(jcfg, tree, jb) -> np.ndarray:
    """The top-k experts the reference's forward picks in its one MoE layer
    of the layer scan (the reduced MoE configs have a dense ``layer0`` and
    one MoE layer)."""
    assert jcfg.layer_kinds() == ("dense0", "moe")
    seen, route = [], jmoe._route

    def recorded(x_flat, router_w, moe):
        out = route(x_flat, router_w, moe)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), out[0], ordered=True)
        return out

    jmoe._route = recorded
    try:
        jax.block_until_ready(jax.jit(lambda p, b: jtf.lm_loss(p, b, jcfg, JLOCAL))(
            jax.tree.map(jnp.asarray, tree), jb))
    finally:
        jmoe._route = route
    assert len(seen) == 1
    return seen[0]


def _replay(monkeypatch, topi: np.ndarray) -> None:
    """Both sides' ``_route`` take ``topi`` as their top-k choice, with the
    weights from their own router probabilities, as they would give them."""
    jroute, troute = jmoe._route, tmoe._route

    def jreplayed(x_flat, router_w, moe):
        _, _, probs = jroute(x_flat, router_w, moe)
        want = jnp.asarray(topi)
        w = jnp.take_along_axis(probs, want, axis=-1)
        if moe.norm_topk:
            w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
        return want, w.astype(x_flat.dtype), probs

    def treplayed(x_flat, router_w, moe):
        _, _, probs = troute(x_flat, router_w, moe)
        want = torch.from_numpy(topi).long()
        w = probs.gather(1, want)
        if moe.norm_topk:
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        return want, w.to(x_flat.dtype), probs

    monkeypatch.setattr(jmoe, "_route", jreplayed)
    monkeypatch.setattr(tmoe, "_route", treplayed)


def _whisper_tree(jcfg, seed):
    shapes = jax.eval_shape(lambda: jwhisper.init_whisper_params(jax.random.PRNGKey(0), jcfg))
    return _np_tree(shapes, seed)


def _jax_whisper_grads(jcfg, tree, jb):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jwhisper.whisper_loss(p, b, jcfg, JLOCAL), has_aux=True))
    (jloss, _), jgrads = fn(jax.tree.map(jnp.asarray, tree), jb)
    return jloss, jgrads


@functools.lru_cache(maxsize=None)
def _f32_reference(arch):
    """The reference's f32 loss, metrics and gradients on the tree and
    batch ``check_lm_loss`` uses, once per arch (and routes)."""
    jcfg, _ = cfgs(arch, "float32")
    tree = _lm_tree(jcfg, 0)
    return tree, _batch(jcfg.vocab, 2, 1), _jax_loss_and_grads(jcfg, tree, _jbatch(*_batch(jcfg.vocab, 2, 1)))


def check_lm_loss(arch, dtype, monkeypatch):
    """``lm_loss`` and every leaf's gradient of the port against the
    reference's, at ``dtype``, on reduced ``arch`` (module docstring)."""
    jcfg, cfg = cfgs(arch, dtype)
    tree, (tokens, targets), ref32 = _f32_reference(arch)
    jb, tb = _jbatch(tokens, targets), _tbatch(tokens, targets)
    if dtype == "float32":
        (jloss, jm, jgrads), f32_grads, rel, loss_rel = ref32, None, F32_GRAD, LOSS_RTOL
    else:
        if cfg.moe is not None:
            _replay(monkeypatch, _reference_routes(jcfg, tree, jb))
            ref32 = _jax_loss_and_grads(cfgs(arch, "float32")[0], tree, jb)
        jloss, jm, jgrads = _jax_loss_and_grads(jcfg, tree, jb)
        f32_grads, rel, loss_rel = ref32[2], BF16, BF16
    loss, m, grads = _port_loss_and_grads(cfg, tree, tb)
    assert loss == pytest.approx(jloss, rel=loss_rel)
    assert m["xent"] == pytest.approx(jm["xent"], rel=loss_rel)
    assert m["aux"] == pytest.approx(jm["aux"], rel=loss_rel, abs=1e-12)
    if cfg.moe is not None:
        assert m["aux"] > 0
    _grads_close(jgrads, grads, rel, f"{arch} {dtype} grad", f32_grads=f32_grads)
    return jgrads, grads


def check_whisper_loss(dtype, rel):
    jcfg, cfg = cfgs(ENCDEC_IDS[0], dtype)
    tree = _whisper_tree(jcfg, 5)
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((2, cfg.encoder.frames, cfg.d_model)).astype(np.float32)
    tokens, targets = _batch(cfg.vocab, 2, 7)
    jb = dict(_jbatch(tokens, targets), frames=jnp.asarray(frames))
    jloss, jgrads = _jax_whisper_grads(jcfg, tree, jb)
    jgrads32 = None if dtype == "float32" else _jax_whisper_grads(cfgs(ENCDEC_IDS[0], "float32")[0], tree, jb)[1]
    params = _requires_grad(lm_params_from_numpy(tree, device="cpu"))
    loss, metrics = whisper_loss(params, dict(_tbatch(tokens, targets), frames=torch.from_numpy(frames)), cfg)
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL if dtype == "float32" else BF16)
    assert float(metrics["xent"]) == float(loss)
    _grads_close(jgrads, _port_grads(params), rel, f"whisper {dtype} grad", f32_grads=jgrads32)


class StandInGroup:
    """A stand-in process group of ``n`` ranks, for what reads only a
    group's size and rank (the specs; refusals that come before any
    collective)."""

    def __init__(self, n: int):
        self.n = n

    def size(self) -> int:
        return self.n

    def rank(self) -> int:
        return 0


@contextlib.contextmanager
def one_process_model_group(n: int):
    """A model group of ``n`` ranks in this one process, for a check that a
    distributed path runs to its end: torch's ``fake`` process group
    (collectives that move nothing; the results are not the ranks' sums),
    rank 0 of ``n``, taken down on leaving the block. Yields a mesh
    {"data": one rank, "model": the group}."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models.policy import ONE_RANK

    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield {"data": ONE_RANK, "model": dist.new_group(list(range(n)))}
    finally:
        dist.destroy_process_group()
