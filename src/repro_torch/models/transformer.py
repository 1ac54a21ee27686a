"""Decoder LMs (dense, MoE, SSM, hybrid): parameters, training loss, prefill, decode.

Port of ``repro.models.transformer`` under the local policy:
``init_lm_params``, ``_init_layer``, ``_norm``; training's
``_apply_layer``, ``_remat``, ``lm_hidden`` and ``lm_loss``; serving's
prefill layer, ``lm_prefill``, ``_attn_prefill`` (with the sliding
window's ring), ``_mla_prefill``, ``_rglru_prefill``, ``init_cache``,
``_decode_layer`` and ``lm_decode_step``; the tensor-parallel specs
(``param_specs``, ``_layer_specs``, ``_mlp_specs``, ``_stack_specs``) as
tuples, with ``shard_params``/``gather_params`` that cut a tree into a
rank's shards by them and put it back, and ``lm_hidden``/``lm_loss`` under
a mesh policy (``models/policy.py``); serving under one:
``use_split_cache``, ``cache_specs``, ``init_cache``, ``lm_prefill`` and
``lm_decode_step`` with a policy, and ``flush_tails``.
Parameters keep the reference's tree and leaf names, with the layers
stacked on a leading layer dim::

    {"embed": [V, d], "final_norm": [d], "lm_head": [d, V], "layer0": None,
     "layers": {"ln1": [L, d], "attn": {"wq": [L, d, h*hd], ...},
                "ln2": [L, d], "mlp": {...}}}

An MoE config whose first layer is dense (``moe.first_dense_ff``) keeps
that layer unstacked under ``layer0`` and stacks the ``moe`` layers, which
hold {"router", "w_gate": [L, E, d, f], ..., "shared": {...}} under
``moe`` in place of ``mlp``; under MLA ``attn`` holds {"wq", "w_dkv",
"kv_norm", "k_up", "v_up", "wo"}. An SSM layer holds {"ln1", "mixer"}
(Mamba-2's, ``models/ssm.py``). The hybrid family stacks each position of
its pattern over the superblocks and keeps the layers past the last whole
superblock unstacked, in a list::

    {"embed", "final_norm", "lm_head",
     "superblocks": {"b0_rec": {"ln1", "mixer", "ln2", "mlp"}: [n_super, ...],
                     "b1_rec": ..., "b2_attn": {"ln1", "attn", "ln2", "mlp"}},
     "tail": [{"ln1", "mixer", "ln2", "mlp"}, ...]}

The reference's ``lax.scan`` over a stack is a Python loop over its layer
views. ``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry a parameter
tree across the two packages. Caches are laid out the same way: {"layer0":
None or one layer's, "layers": {"k", "v"}: [L, b, kvh, S, hd]} (under MLA
{"ckv": [L, b, S, kv_lora], "kr": [L, b, S, dh_rope]}; for SSM layers
{"conv": [L, b, k, conv_dim], "state": [L, b, H, N, p]}), and for the
hybrid family {"superblocks": {"b0_rec": {"conv", "h"}, ..., "b2_attn":
{"k", "v"}}, "tail": [...]}, the attention caches rings of
min(max_len, window) positions. ``lm_decode_step`` updates them in place.
Under a mesh policy the attention caches without a window are split, a
prefix and a ``TAIL_LEN`` tail ({"k", "v", ("k_scale", "v_scale"), "tk",
"tv"}, ``attention.init_kv_cache``; under MLA {"ckv", "kr", "tckv",
"tkr"}), and a rank holds its part of them (``cache_specs``): its data
rank's rows, its kv heads of the prefix or, where P does not divide them
and always under MLA, its chunk of the prefix's positions.

Every RMSNorm goes through the fused RMSNorm kernel and every prefill
attention within the window through the flash-attention kernel (their
plain versions for CPU tensors): ``norms_per_forward(cfg)`` norms per
prefill or decode step (2 L + 1, plus 2 L with qk-norm and L with MLA's
latent norm; an SSM layer's second norm is its mixer's gated norm) and
``flash_per_prefill(cfg, s)`` flash launches per prefill of s tokens;
``train_launches(cfg, s)`` both per forward + backward of ``lm_loss``
(on every rank of a mesh alike).

Under a mesh policy whose model group has P > 1 ranks each rank holds its
shards (``shard_params``) and its rows of the batch, and the blocks run
Megatron-style: the embedding table split over d_model columns (an
all-gather of the looked-up columns, or under ``seq_shard`` an all-to-all
to this rank's slice of the sequence), attention and the MLPs column- then
row-parallel (``attention._attn_tp``, ``layers.tp_mlp``), the MoE's
routed experts over the all-to-all, the cross-entropy vocab-parallel
(MLA: ``attention._mla_tp``, its heads column-parallel, the latent's
down-projection whole on every rank). The
residual stream is whole on every rank, or under ``seq_shard`` this
rank's slice of the sequence, where the norms run on its rows (their
weights' gradient then a part, summed over the group by ``copy_to``'s
backward). The SSM mixer is tensor-parallel over its heads
(``ssm.ssm_forward`` with a group: its gated norm's statistic summed over
the group); the RG-LRU mixer is replicated (``rglru.rglru_forward``: the
whole sequence gathered under ``seq_shard``), its MLPs and the hybrid's
local attention tensor-parallel. So every rank's gradient of every leaf is
the whole of it for the rows of its data rank:
``train.train_loop.reduce_grads`` averages it over the data group.

Serving under such a policy runs the same blocks without their backward:
the prefill tensor-parallel as ``lm_hidden``, each attention layer writing
this rank's part of its prefix (a window's ring: this rank's slots of
it); the decode step's attention over the split cache
(``attention._attn_decode_split``: by kv heads, or by sequence with the
softmax combined over the model group; MLA's absorbed
``attention._mla_decode_split`` by sequence) or over the ring
(``attention._ring_decode`` by sequence), the SSM state this rank's
heads, the RG-LRU's cache whole, the MoE's
experts split over the group where the all-to-all's condition fails
(``moe._moe_together``), the vocab-split logits all-gathered.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.core.collectives import copy_to, gather_from, scatter_to
from repro_torch.core.partition import CartPartition, gather_dim, local_slice
from repro_torch.core.repartition import repartition
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.policy import DATA_AXIS, LOCAL, MODEL_AXIS, ParallelPolicy

# leaves that stay float32 when the serving runner casts the rest to the
# activation dtype (the reference casts every other weight at its matmul).
# MLA's k_up and v_up, and both recurrent mixers' conv weights and biases:
# the reference casts them at the prefill's matmuls and convs but runs the
# decode with them in float32, so the runner keeps them float32 and the
# prefill casts them at each use. The SSM's A_log, D, dt_bias and gated
# norm weight, and the RG-LRU's gates (w_r, b_r, w_i, b_i, lambda) are
# used in float32 throughout.
F32_LEAVES = ("embed", "final_norm", "ln1", "ln2", "q_norm", "k_norm", "kv_norm", "k_up", "v_up",
              "A_log", "D", "dt_bias", "norm_w", "conv_x", "conv_B", "conv_C", "conv_bx",
              "conv_bB", "conv_bC", "conv_w", "conv_b", "w_r", "b_r", "w_i", "b_i", "lambda")
# the cache leaves that hold a position per token along their second-to-last dim
_SEQ_LEAVES = ("k", "v", "ckv", "kr")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _normal(shape, std, generator, device):
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def _init_attn(cfg, normal, const) -> dict:
    d, hd, h, kvh = cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.kv_heads
    std = d ** -0.5
    attn = {"wq": normal("wq", (d, h * hd), std), "wk": normal("wk", (d, kvh * hd), std),
            "wv": normal("wv", (d, kvh * hd), std), "wo": normal("wo", (h * hd, d), std)}
    if cfg.qkv_bias:
        attn.update(bq=const("bq", (h * hd,), 0.0), bk=const("bk", (kvh * hd,), 0.0),
                    bv=const("bv", (kvh * hd,), 0.0))
    if cfg.qk_norm:
        attn.update(q_norm=const("q_norm", (hd,), 1.0), k_norm=const("k_norm", (hd,), 1.0))
    return attn


def _init_mlp(d, f, act, normal, const) -> dict:
    std_d, std_f = d ** -0.5, f ** -0.5
    if act in ("swiglu", "geglu"):
        return {"w_gate": normal("w_gate", (d, f), std_d), "w_up": normal("w_up", (d, f), std_d),
                "w_down": normal("w_down", (f, d), std_f)}
    return {"w1": normal("w1", (d, f), std_d), "b1": const("b1", (f,), 0.0),
            "w2": normal("w2", (f, d), std_f), "b2": const("b2", (d,), 0.0)}


class _Makers(NamedTuple):
    """Leaf makers: ``normal(name, shape, std)``, ``const(name, shape,
    value)`` (a float or a tensor of ``shape``) and ``uniform(name, shape,
    lo, hi, fn)``; each makes a leaf stacked or not, finished as it
    chooses."""
    normal: Callable
    const: Callable
    uniform: Callable


def _init_layer(cfg, kind: str, mk: _Makers) -> dict:
    """One layer's leaves for ``kind`` (dense, dense0, moe, ssm, rec or attn)."""
    normal, const = mk.normal, mk.const
    d = cfg.d_model
    p = {"ln1": const("ln1", (d,), 1.0)}
    if kind == "ssm":
        p["mixer"] = ssm_lib.init_ssm_params(d, cfg.ssm, normal, const)
        return p
    if kind == "rec":
        p["mixer"] = rglru_lib.init_rglru_params(d, cfg.rglru, normal, const, mk.uniform)
        p["ln2"] = const("ln2", (d,), 1.0)
        p["mlp"] = _init_mlp(d, cfg.d_ff, cfg.mlp_act, normal, const)
        return p
    if cfg.mla is not None:
        p["attn"] = attn_lib.init_mla_params(cfg, normal, lambda name, shape: const(name, shape, 1.0))
    else:
        p["attn"] = _init_attn(cfg, normal, const)
    p["ln2"] = const("ln2", (d,), 1.0)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe_params(d, cfg.moe, normal)
    else:
        f = cfg.moe.first_dense_ff if kind == "dense0" else cfg.d_ff
        p["mlp"] = _init_mlp(d, f, cfg.mlp_act, normal, const)
    return p


def leaf_makers(lead: tuple, generator, device, finish) -> _Makers:
    """Makers of float32 leaves stacked on ``lead``, drawn from
    ``generator`` on ``device``; ``finish(name, leaf)`` returns what is
    kept (the leaf itself, or its serving cast)."""
    def normal(name, shape, std):
        return finish(name, _normal(lead + tuple(shape), std, generator, device))

    def const(name, shape, value):
        full = lead + tuple(shape)
        if isinstance(value, torch.Tensor):
            return finish(name, value.to(device=device, dtype=torch.float32).expand(full).clone())
        return finish(name, torch.full(full, value, dtype=torch.float32, device=device))

    def uniform(name, shape, lo, hi, fn):
        u = torch.rand(lead + tuple(shape), generator=generator, device=device)
        return finish(name, fn(u * (hi - lo) + lo))
    return _Makers(normal, const, uniform)


def _serving_dtype(name: str, cfg) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES else cfg.activation_dtype


def hybrid_layout(cfg) -> tuple:
    """(pattern, superblocks, tail layers) of a hybrid config."""
    pat = cfg.pattern
    n_super, tail = divmod(cfg.n_layers, len(pat))
    return pat, n_super, tail


def init_lm_params(cfg, *, generator: torch.Generator, device=None, serving: bool = False) -> dict:
    """Random float32 parameters with the reference's leaves, scales and
    stacking, drawn from ``generator`` (which must live on ``device``) one
    leaf at a time. With ``serving`` each leaf is cast as soon as it is
    drawn to what ``serving_params`` would hold (bitwise the same), so the
    float32 masters never coexist: the peak is the cast tree plus one
    float32 leaf."""
    device = resolve_device(device)
    v, d = cfg.vocab, cfg.d_model
    finish = (lambda name, t: t.to(_serving_dtype(name, cfg))) if serving else (lambda name, t: t)

    def makers(lead):
        return leaf_makers(lead, generator, device, finish)

    params = {
        "embed": finish("embed", _normal((v, d), d ** -0.5, generator, device)),
        "final_norm": finish("final_norm", torch.ones(d, device=device)),
        "lm_head": finish("lm_head", _normal((d, v), d ** -0.5, generator, device)),
    }
    if cfg.family == "hybrid":
        pat, n_super, tail = hybrid_layout(cfg)
        params["superblocks"] = {f"b{i}_{kind}": _init_layer(cfg, kind, makers((n_super,)))
                                 for i, kind in enumerate(pat)}
        params["tail"] = [_init_layer(cfg, pat[i % len(pat)], makers(())) for i in range(tail)]
        return params
    kinds = cfg.layer_kinds()
    first = kinds[0] == "dense0"
    params["layer0"] = _init_layer(cfg, "dense0", makers(())) if first else None
    params["layers"] = _init_layer(cfg, kinds[-1], makers((len(kinds) - first,)))
    return params


def _tree_map(fn, tree, name=None, leaf=lambda t: False):
    """``fn(leaf, name)`` over a tree of dicts and lists (None stays None);
    ``name`` is the key of the dict that holds the leaf; ``leaf(t)`` marks
    a node to take as a leaf (a spec tuple)."""
    if tree is None:
        return None
    if leaf(tree):
        return fn(tree, name)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, name, leaf) for v in tree]
    return fn(tree, name)


def lm_params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's parameter tree (numpy leaves, ``layer0`` None or the
    first dense layer's, layers stacked; the hybrid's superblocks stacked
    and its tail a list) as the port's: the same tree of float32 tensors
    on ``device``."""
    device = resolve_device(device)
    return _tree_map(lambda a, _: torch.from_numpy(np.array(a, np.float32)).to(device), tree)


def lm_params_to_numpy(params: dict) -> dict:
    """The port's parameters as the reference's tree of float32 numpy arrays."""
    return _tree_map(lambda t, _: t.detach().float().cpu().numpy(), params)


def serving_params(params: dict, cfg, device) -> dict:
    """The parameters a serving runner holds: every matmul weight and bias
    cast once to the activation dtype (what the reference's per-matmul
    ``.astype(x.dtype)`` computes, bitwise), ``F32_LEAVES`` float32 (the
    embedding table, the norm weights, MLA's up-projections, the recurrent
    mixers' convs, gates and decay parameters), all on ``device``. Leaves
    already in place are shared, not copied."""
    return _tree_map(lambda t, name: t.to(device=device, dtype=_serving_dtype(name, cfg)), params)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s leaves, as views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Partition specs (tensor parallelism over the model axis) and shards
# ---------------------------------------------------------------------------

def _mlp_specs(act: str, mx: str) -> dict:
    if act in ("swiglu", "geglu"):
        return {"w_gate": (None, mx), "w_up": (None, mx), "w_down": (mx, None)}
    return {"w1": (None, mx), "b1": (mx,), "w2": (mx, None), "b2": ()}


def _layer_specs(cfg, kind: str, mx: str) -> dict:
    """One layer's specs, the reference's (``transformer.py:124-173``):
    an SSM mixer's inner width split, an RG-LRU mixer whole."""
    s = {"ln1": ()}
    if kind == "ssm":
        s["mixer"] = {
            "w_z": (None, mx), "w_x": (None, mx), "w_B": (), "w_C": (),
            "w_dt": (), "conv_x": (None, mx), "conv_B": (), "conv_C": (),
            "conv_bx": (mx,), "conv_bB": (), "conv_bC": (),
            "A_log": (), "D": (), "dt_bias": (), "norm_w": (mx,),
            "out_proj": (mx, None),
        }
        return s
    if kind == "rec":
        s["mixer"] = {name: () for name in ("w_x", "w_gate", "conv_w", "conv_b", "w_r", "b_r",
                                            "w_i", "b_i", "lambda", "w_out")}
        s["ln2"] = ()
        s["mlp"] = _mlp_specs(cfg.mlp_act, mx)
        return s
    if cfg.mla is not None:
        s["attn"] = {"wq": (None, mx), "w_dkv": (None, None), "kv_norm": (),
                     "k_up": (None, mx), "v_up": (None, mx), "wo": (mx, None)}
    else:
        a = {"wq": (None, mx), "wk": (None, mx), "wv": (None, mx), "wo": (mx, None)}
        if cfg.qkv_bias:
            a.update({"bq": (mx,), "bk": (mx,), "bv": (mx,)})
        if cfg.qk_norm:
            a.update({"q_norm": (), "k_norm": ()})
        s["attn"] = a
    s["ln2"] = ()
    if kind == "moe":
        s["moe"] = moe_lib.moe_param_specs(cfg.moe)
    else:
        s["mlp"] = _mlp_specs(cfg.mlp_act, mx)
    return s


def _stack_specs(spec_tree):
    """Every leaf spec prefixed with None for the stacked layer dim."""
    return _tree_map(lambda p, _: (None, *p), spec_tree, leaf=lambda t: isinstance(t, tuple))


def param_specs(cfg, policy: ParallelPolicy) -> dict:
    """The reference's ``param_specs`` (``transformer.py:179-207``) for
    every decoder family, a ``PartitionSpec`` as the tuple of its entries:
    (None, "model") for P(None, mx), () for P(). The embedding splits its
    d_model columns and lm_head its vocab where P divides them."""
    mx = MODEL_AXIS
    p_model = policy.model_size()
    specs = {
        "embed": (None, mx) if cfg.d_model % p_model == 0 else (None, None),
        "final_norm": (),
        "lm_head": (None, mx) if cfg.vocab % p_model == 0 else (None, None),
    }
    if cfg.family == "hybrid":
        pat, _, tail = hybrid_layout(cfg)
        specs["superblocks"] = _stack_specs(
            {f"b{i}_{kind}": _layer_specs(cfg, kind, mx) for i, kind in enumerate(pat)})
        specs["tail"] = [_layer_specs(cfg, pat[i % len(pat)], mx) for i in range(tail)]
        return specs
    kinds = cfg.layer_kinds()
    specs["layer0"] = _layer_specs(cfg, "dense0", mx) if kinds[0] == "dense0" else None
    specs["layers"] = _stack_specs(_layer_specs(cfg, kinds[-1], mx))
    return specs


def tree_specs(cfg, policy: ParallelPolicy) -> dict:
    """The spec tree of ``cfg``'s parameters: ``param_specs``, or for the
    encoder-decoder family ``whisper.whisper_param_specs``."""
    if cfg.family == "encdec":
        from repro_torch.models.whisper import whisper_param_specs  # it imports this module

        return whisper_param_specs(cfg)
    return param_specs(cfg, policy)


def _walk(fn, params, specs):
    """``fn(leaf, spec)`` over a parameter tree beside its spec tree."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: _walk(fn, v, specs[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_walk(fn, v, sp) for v, sp in zip(params, specs)]
    return fn(params, specs)


def _model_dim(spec, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def param_parts(cfg, policy: ParallelPolicy, params: dict) -> dict:
    """The ``CartPartition`` of each leaf of ``params`` over the groups'
    names (None: whole on every rank), for a ``StateLayout``."""
    def part(leaf, spec):
        if _model_dim(spec, MODEL_AXIS) is None or policy.model_size() == 1:
            return None
        return CartPartition(tuple(spec) + (None,) * (leaf.dim() - len(spec)))

    return _walk(part, params, tree_specs(cfg, policy))


def shard_params(params: dict, cfg, policy: ParallelPolicy) -> dict:
    """This rank's shards of a whole (serial, or converted-from-JAX)
    parameter tree of any family (whisper's too): each leaf split by
    ``tree_specs`` cut to this rank's slice of its model-axis dim (a
    copy), the others as they are."""
    group = policy.model_group

    def cut(leaf, spec):
        dim = _model_dim(spec, MODEL_AXIS)
        if dim is None or policy.model_size() == 1:
            return leaf
        return local_slice(leaf, dim, group).clone()

    return _walk(cut, params, tree_specs(cfg, policy))


def gather_params(local: dict, cfg, policy: ParallelPolicy) -> dict:
    """The inverse of ``shard_params`` (a collective over the model
    group): every leaf whole, bitwise the tree it was cut from."""
    group = policy.model_group

    def whole(leaf, spec):
        dim = _model_dim(spec, MODEL_AXIS)
        if dim is None or policy.model_size() == 1:
            return leaf
        return gather_dim(leaf, dim, group)

    return _walk(whole, local, tree_specs(cfg, policy))


def check_mesh_arch(cfg, policy: ParallelPolicy) -> None:
    """Raise for what a model group cannot split: MLA heads (they are not
    padded) and SSM heads (where the group does not divide them the
    reference replicates the state, and a column split of w_x would cut a
    head); for the encoder-decoder family, columns of its attention or MLP
    projections that the group does not divide (its specs cut them
    evenly), and GQA heads that it does not divide (its ranks' caches
    would hold different numbers of kv heads). A window's ring that the
    group does not divide is refused where it is allocated
    (``_new_cache``)."""
    p = policy.model_size()
    if p == 1:
        return
    if cfg.family == "encdec":
        hd = cfg.head_dim_
        for what, n in (("q projection", cfg.n_heads * hd), ("kv projections", cfg.kv_heads * hd),
                        ("MLP", cfg.d_ff)):
            if n % p:
                raise ValueError(f"{cfg.name}: the {n} columns of the {what} do not split over "
                                 f"{p} model ranks")
        if cfg.kv_heads != cfg.n_heads and cfg.n_heads % p:
            raise ValueError(f"{cfg.name}: {cfg.n_heads} heads over {cfg.kv_heads} kv heads do "
                             f"not split over {p} model ranks")
    if cfg.mla is not None and cfg.n_heads % p:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} MLA heads do not split over {p} model ranks")
    if cfg.ssm is not None and cfg.ssm.n_heads(cfg.d_model) % p:
        raise ValueError(f"{cfg.name}: {cfg.ssm.n_heads(cfg.d_model)} SSM heads do not split over "
                         f"{p} model ranks")


# ---------------------------------------------------------------------------
# Cache specs (the serving caches over the mesh)
# ---------------------------------------------------------------------------

def use_split_cache(cfg, policy: ParallelPolicy) -> bool:
    """Split prefix/tail caches for every attention decode under a mesh
    without a sliding window (``attention.init_kv_cache``): the reference's
    rule."""
    return policy.distributed and cfg.window is None


def _layer_cache_specs(cfg, policy: ParallelPolicy, kind: str) -> dict:
    """The spec of each leaf of one layer's cache (``cache_specs``)."""
    mx, dp, p_size = MODEL_AXIS, DATA_AXIS, policy.model_size()
    split = use_split_cache(cfg, policy)
    if kind == "ssm":
        h = cfg.ssm.n_heads(cfg.d_model)
        return {"conv": (dp, None, None), "state": (dp, mx if h % p_size == 0 else None, None, None)}
    if kind == "rec":  # whole, as the mixer's leaves (the reference cuts it by width)
        return {"conv": (dp, None, None), "h": (dp, None)}
    if cfg.mla is not None:
        s = {"ckv": (dp, mx, None), "kr": (dp, mx, None)}
        if split:
            s.update(tckv=(dp, None, None), tkr=(dp, None, None))
        return s
    if attn_lib.prefix_by_sequence(cfg, policy):
        s, sc, t = (dp, None, mx, None), (dp, None, mx), (dp, None, None, None)
    else:
        s, sc = (dp, mx, None, None), (dp, mx, None)
        t = s
    if not split:
        return {"k": s, "v": s}
    spec = {"k": s, "v": s, "tk": t, "tv": t}
    if policy.kv_quant:
        spec.update(k_scale=sc, v_scale=sc)
    return spec


def cache_specs(cfg, policy: ParallelPolicy) -> dict:
    """The cache tree's layout over the mesh, a spec as the tuple of its
    entries, matching ``init_cache``'s tree (which allocates by it): the
    reference's ``cache_specs`` (``transformer.py:369-446``) but for a
    split cache's tail. The batch over the data axis; a split cache's
    prefix over the model axis by kv heads where it divides them, else (and
    MLA's latent prefix always) by sequence (each model rank a contiguous
    chunk, the softmax combined over the group). The tail is whole beside
    a sequence-sharded prefix, as the reference's, and cut by kv heads
    beside a head-sharded one, where the reference replicates it: a rank's
    decode attends over its kv heads alone. The SSM cache as the reference
    shards it (the state by heads, the conv whole). The RG-LRU's cache is
    whole on every rank, where the reference cuts it by width wherever P
    divides that while it replicates the mixer that fills it: with its
    layout a decode step would need an all-gather of the mixer's input
    and an all-reduce of its output in every rec layer, where the port's
    costs no collective (2560 f32 a row at full width)."""
    def one(kind):
        return _layer_cache_specs(cfg, policy, kind)

    if cfg.family == "hybrid":
        pat, _, tail = hybrid_layout(cfg)
        return {"superblocks": _stack_specs({f"b{i}_{kind}": one(kind) for i, kind in enumerate(pat)}),
                "tail": [one(pat[i % len(pat)]) for i in range(tail)]}
    kinds = cfg.layer_kinds()
    if kinds[0] == "dense0":
        return {"layer0": one("attn"), "layers": _stack_specs(one(kinds[1]))}
    return {"layer0": None, "layers": _stack_specs(one(kinds[0]))}


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _norm(x, w, cfg, part_of=None):
    """The block's norm; ``part_of``: the model group when x is this
    rank's slice of the sequence, so that w's gradient here is a part of
    it, summed over the group in the backward."""
    if part_of is not None:
        w = copy_to(w, part_of)
    if cfg.norm == "ln":  # as the reference: LayerNorm with a zero bias
        return layers.layer_norm(x, w, torch.zeros_like(w), eps=cfg.norm_eps)
    return layers.rms_norm(x, w, eps=cfg.norm_eps)


def _mlp(h, p, cfg, policy: ParallelPolicy = LOCAL, seq_sharded: bool = False):
    if policy.model_size() > 1:
        return layers.tp_mlp(h, p, cfg.mlp_act, policy.model_group, seq_sharded)
    if cfg.mlp_act in ("swiglu", "geglu"):
        return layers.glu_mlp(h, p["w_gate"], p["w_up"], p["w_down"], act=cfg.mlp_act)
    return layers.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"], act=cfg.mlp_act)


def _ffn(h, lp, kind, cfg, dropless=False, policy: ParallelPolicy = LOCAL, sp: bool = False):
    """The layer's feed-forward half when serving: routed + shared experts
    (their load-balance loss dropped), or an MLP."""
    if kind == "moe":
        return moe_lib.moe_apply(lp["moe"], h, cfg.moe, policy, dropless=dropless,
                                 seq_sharded=sp)[0]
    return _mlp(h, lp["mlp"], cfg, policy, sp)


def _embed_in(params, tokens, cfg, policy: ParallelPolicy = LOCAL, seq_sharded: bool = False):
    """Token ids -> the residual stream in the activation dtype. Over a
    model group: a table of this rank's d_model columns looks up its
    columns, all-gathered (or under ``seq_shard`` moved by one all-to-all
    to this rank's slice of the sequence); a whole table looks up every
    token, this rank keeping its slice under ``seq_shard``."""
    x = layers.embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.embed_scale,
                     dim=cfg.d_model).to(cfg.activation_dtype)
    if policy.model_size() == 1:
        return x
    group = policy.model_group
    if policy.splits(cfg.d_model):
        # contiguous: the norm kernel takes the stream as rows
        return repartition(x, 2, 1, group).contiguous() if seq_sharded else gather_from(x, 2, group)
    return scatter_to(x, 1, group) if seq_sharded else x


def norms_per_forward(cfg, model_ranks: int = 1) -> int:
    """RMSNorm launches of one prefill or decode step on a rank of a model
    group of ``model_ranks``: two per layer (ln1 and ln2, or an SSM layer's
    ln1 and its mixer's gated norm, which over a group of more than one
    rank runs in plain ops and launches none), the final norm, q- and
    k-norm per layer with ``qk_norm``, and the latent's kv_norm per layer
    under MLA. Under ``norm="ln"`` ln1, ln2 and the final norm are
    LayerNorms, which launch no kernel."""
    kinds = cfg.layer_kinds()
    n = len(kinds)
    layer_norms = 2 * n + 1 if cfg.norm == "rms" else 0
    split = sum(kind == "ssm" for kind in kinds) if model_ranks > 1 else 0
    return layer_norms - split + (2 * n if cfg.qk_norm else 0) + (n if cfg.mla is not None else 0)


def attention_layers(cfg) -> int:
    """The layers that attend (every layer but the SSM and RG-LRU ones)."""
    return sum(kind not in ("ssm", "rec") for kind in cfg.layer_kinds())


def flash_per_prefill(cfg, s: int) -> int:
    """Flash-attention launches of a prefill of ``s`` tokens: one per
    attention layer, none past a sliding window (``_windowed_attention``
    takes those prompts, as in the reference)."""
    return 0 if cfg.window is not None and s > cfg.window else attention_layers(cfg)


def _check_layer0(cfg, params) -> bool:
    """Whether the first layer is the unstacked dense ``layer0``; raises
    when the params and the config disagree on it."""
    kinds = cfg.layer_kinds()
    first = kinds[0] == "dense0"
    if first != (params.get("layer0") is not None):
        raise ValueError(f"{cfg.name}: layer0 params {'missing' if first else 'given'} for "
                         f"layer kinds {kinds[:2]}...")
    return first


def _layers(cfg, params, cache):
    """(layer params, layer cache, kind) of every layer in order; the
    stacked ones as views."""
    if cfg.family == "hybrid":
        pat, n_super, tail = hybrid_layout(cfg)
        if len(params["tail"]) != tail:
            raise ValueError(f"{cfg.name}: {len(params['tail'])} tail layers given, {tail} expected")
        out = []
        for j in range(n_super):
            for i, kind in enumerate(pat):
                name = f"b{i}_{kind}"
                out.append((layer_params(params["superblocks"][name], j),
                            {n: c[j] for n, c in cache["superblocks"][name].items()}, kind))
        return out + [(lp, lc, pat[i % len(pat)])
                      for i, (lp, lc) in enumerate(zip(params["tail"], cache["tail"]))]
    kinds = cfg.layer_kinds()
    first = _check_layer0(cfg, params)
    out = [(params["layer0"], cache["layer0"], kinds[0])] if first else []
    stacked = cache["layers"]
    for i in range(len(kinds) - first):
        out.append((layer_params(params["layers"], i), {n: c[i] for n, c in stacked.items()},
                    kinds[first + i]))
    return out


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

# what ``remat_policy="dots"`` keeps from a layer's forward for its backward:
# the outputs of the matrix products (every ``@`` and einsum lands on one of
# these), as the reference's ``dots_saveable`` keeps its dot_generals'
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _keep_dots(ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if func in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, policy):
    """``body`` as the reference's ``_remat`` wraps its scan body:
    unchanged without ``policy.remat``, else under a non-reentrant
    ``torch.utils.checkpoint``, which keeps none of its activations (with
    ``remat_policy="dots"``, the matrix products' outputs) and runs it
    again in the backward."""
    if not policy.remat:
        return body
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {"use_reentrant": False}
    if policy.remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(_keep_dots)
    return lambda *args: checkpoint(body, *args, **kw)


def _mixer_group(policy: ParallelPolicy):
    """The model group an SSM mixer splits its heads over, or None."""
    return policy.model_group if policy.model_size() > 1 else None


def _apply_layer(x, aux, lp, kind, cfg, policy: ParallelPolicy = LOCAL, sp: bool = False):
    """One block of the training forward (the reference's
    ``_apply_layer``): returns (x, aux plus the block's load-balance loss).
    The MoE blocks route with capacity (``_capacity``: entries past it
    drop), as the reference's training does. ``sp``: x is this rank's
    slice of the sequence (``seq_shard`` under a mesh)."""
    part_of = policy.model_group if sp else None
    h = _norm(x, lp["ln1"], cfg, part_of)
    if kind == "ssm":
        return x + ssm_lib.ssm_forward(lp["mixer"], h, cfg.d_model, cfg.ssm,
                                       group=_mixer_group(policy), seq_sharded=sp), aux
    if kind == "rec":
        x = x + rglru_lib.rglru_forward(lp["mixer"], h, cfg.rglru, cfg.d_model, seq_group=part_of)
    elif cfg.mla is not None:
        x = x + attn_lib.mla_forward(lp["attn"], h, cfg, policy, seq_sharded=sp)
    else:
        x = x + attn_lib.attn_forward(lp["attn"], h, cfg, policy, seq_sharded=sp)
    h = _norm(x, lp["ln2"], cfg, part_of)
    if kind == "moe":
        y, a = moe_lib.moe_apply(lp["moe"], h, cfg.moe, policy, seq_sharded=sp)
        return x + y, aux + a
    return x + _mlp(h, lp["mlp"], cfg, policy, sp), aux


def _train_layers(cfg) -> list:
    """(kind, whether the reference's layer scan holds it, so that remat
    wraps it) of every layer in order: the hybrid's superblocks but not its
    tail, every stacked layer but not ``layer0``."""
    kinds = cfg.layer_kinds()
    if cfg.family == "hybrid":
        pat, n_super, _ = hybrid_layout(cfg)
        return [(kind, i < n_super * len(pat)) for i, kind in enumerate(kinds)]
    return [(kind, kind != "dense0") for kind in kinds]


def lm_hidden(params, tokens, cfg, policy: ParallelPolicy = LOCAL):
    """Token ids [b, s] -> (final-norm hidden states [b, s, d] in the
    activation dtype, the layers' summed load-balance loss, float32).

    The reference's scan over the stacked layers is a loop over their
    views (or over the per-layer views the train step hands in), each
    layer (the hybrid's each superblock) under ``policy``'s remat; the
    hybrid's tail and ``layer0`` run outside it, as there. Weights are cast
    to the activation dtype at each use; the masters keep theirs.

    Under a mesh policy ``params`` are this rank's shards and ``tokens``
    its rows; the hidden states are this rank's slice of the sequence when
    ``policy.seq_sharded(s)``."""
    check_mesh_arch(cfg, policy)
    sp = policy.seq_sharded(tokens.shape[1])
    x = _embed_in(params, tokens, cfg, policy, sp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        pat, n_super, tail = hybrid_layout(cfg)
        if len(params["tail"]) != tail:
            raise ValueError(f"{cfg.name}: {len(params['tail'])} tail layers given, "
                             f"{tail} expected")

        def super_body(x, aux, sb):
            for i, kind in enumerate(pat):
                x, aux = _apply_layer(x, aux, sb[f"b{i}_{kind}"], kind, cfg, policy, sp)
            return x, aux

        body = _remat(super_body, policy)
        for j in range(n_super):
            x, aux = body(x, aux, layer_params(params["superblocks"], j))
        for i, lp in enumerate(params["tail"]):
            x, aux = _apply_layer(x, aux, lp, pat[i % len(pat)], cfg, policy, sp)
    else:
        kinds = cfg.layer_kinds()
        first = _check_layer0(cfg, params)
        if first:
            x, aux = _apply_layer(x, aux, params["layer0"], kinds[0], cfg, policy, sp)
        body = _remat(lambda x, aux, lp: _apply_layer(x, aux, lp, kinds[-1], cfg, policy, sp),
                      policy)
        for i in range(len(kinds) - first):
            x, aux = body(x, aux, layer_params(params["layers"], i))
    return _norm(x, params["final_norm"], cfg, policy.model_group if sp else None), aux


def lm_loss(params, batch: dict, cfg, policy: ParallelPolicy = LOCAL):
    """The training loss of ``batch`` {"tokens": [b, s], "targets": [b,
    s]}: (mean token cross-entropy + load-balance loss, {"xent", "aux"}),
    as the reference's ``lm_loss``.

    Under a mesh policy ``batch`` holds this rank's rows, ``params`` its
    shards, and the loss is that of its data rank's rows (the same on
    every rank of its model group): lm_head's vocab split over the group
    makes the cross-entropy vocab-parallel (the whole sequence's hidden
    states all-gathered first under ``seq_shard``); a whole lm_head sees
    the whole sequence on every rank."""
    h, aux = lm_hidden(params, batch["tokens"], cfg, policy)
    targets = batch["targets"]
    if policy.model_size() == 1:
        xent = layers.chunked_cross_entropy(h, params["lm_head"], targets)
    else:
        group, sp = policy.model_group, policy.seq_sharded(targets.shape[1])
        if policy.splits(cfg.vocab):
            xent = layers.chunked_cross_entropy(layers.tp_in(h, group, sp), params["lm_head"],
                                                targets, vocab_group=group)
        else:
            h = gather_from(h, 1, group) if sp else h
            xent = layers.chunked_cross_entropy(h, params["lm_head"], targets)
    return xent + aux, {"xent": xent, "aux": aux}


def train_launches(cfg, s: int, model_ranks: int = 1) -> dict:
    """Kernel launches of one forward + backward of ``lm_loss`` with remat
    on, on sequences of ``s`` tokens, on a rank of a model group of
    ``model_ranks``: each layer's norms and attention as in a prefill
    (``norms_per_forward``, ``flash_per_prefill``), twice for a layer that
    remat runs again in the backward, the final norm once; the backward
    itself launches no kernel (the kernels' gradients are their plain
    versions')."""
    layer_norms = ((2 if cfg.norm == "rms" else 0) + (2 if cfg.qk_norm else 0)
                   + (1 if cfg.mla is not None else 0))
    attends = cfg.window is None or s <= cfg.window
    out = {"rmsnorm": 1 if cfg.norm == "rms" else 0, "flash": 0}
    for kind, scanned in _train_layers(cfg):
        runs = 2 if scanned else 1
        out["rmsnorm"] += runs * (layer_norms - (kind == "ssm" and model_ranks > 1))
        out["flash"] += runs * (attends and kind not in ("ssm", "rec"))
    return out


# ---------------------------------------------------------------------------
# Serving: prefill + decode over stacked caches
# ---------------------------------------------------------------------------

def _part_shape(name: str, shape: tuple, spec: tuple, cfg, policy: ParallelPolicy) -> tuple:
    """This rank's part of a cache leaf of ``shape`` (its rows already
    this rank's) over the model group: the dim that ``spec`` puts on the
    model axis cut by P."""
    p = policy.model_size()
    if p == 1 or MODEL_AXIS not in spec:
        return shape
    dim = spec.index(MODEL_AXIS)
    if shape[dim] % p:
        raise ValueError(f"{cfg.name}: the {shape[dim]} entries of the cache leaf {name}'s dim "
                         f"{dim} do not split over {p} model ranks")
    return shape[:dim] + (shape[dim] // p,) + shape[dim + 1:]


def _new_cache(cfg, batch: int, max_len: int, dtype, device, alloc,
               policy: ParallelPolicy = LOCAL) -> dict:
    """The cache tree of ``batch`` rows as this rank holds them, each leaf
    from ``alloc`` and cut over the model group by its spec
    (``cache_specs``): attention leaves in ``dtype`` (split under a mesh,
    ``use_split_cache``; the prefix int8 and its scales bf16 under
    ``kv_quant``), recurrent ones (SSM, RG-LRU) float32, as the
    reference's."""
    split = use_split_cache(cfg, policy)
    ring, p = min(max_len, cfg.window or max_len), policy.model_size()
    if cfg.window is not None and attn_lib.prefix_by_sequence(cfg, policy) and ring % p:
        raise ValueError(f"{cfg.name}: a local-attention ring of {ring} slots does not split over "
                         f"{p} model ranks")

    def make(kind, lead):
        if kind == "ssm":
            leaves = {n: (sh, torch.float32)
                      for n, sh in ssm_lib.cache_shapes(cfg.d_model, cfg.ssm, batch).items()}
        elif kind == "rec":
            leaves = {n: (sh, torch.float32)
                      for n, sh in rglru_lib.cache_shapes(cfg.d_model, cfg.rglru, batch).items()}
        else:
            leaves = attn_lib.cache_leaves(cfg, batch, max_len, dtype, split=split,
                                           quant=policy.kv_quant)
        specs = _layer_cache_specs(cfg, policy, kind)
        return {name: alloc(lead + _part_shape(name, shape, specs[name], cfg, policy), dtype=dt,
                            device=device)
                for name, (shape, dt) in leaves.items()}

    if cfg.family == "hybrid":
        pat, n_super, tail = hybrid_layout(cfg)
        return {"superblocks": {f"b{i}_{kind}": make(kind, (n_super,)) for i, kind in enumerate(pat)},
                "tail": [make(pat[i % len(pat)], ()) for i in range(tail)]}
    kinds = cfg.layer_kinds()
    first = kinds[0] == "dense0"
    return {"layer0": make("attn", ()) if first else None,
            "layers": make(kinds[-1], (len(kinds) - first,))}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
               policy: ParallelPolicy = LOCAL) -> dict:
    """The zeroed cache: {"layer0": one layer's or None, "layers": stacked},
    k and v [L, batch, kvh, max_len, hd], or under MLA ckv [L, batch,
    max_len, kv_lora] and kr [L, batch, max_len, dh_rope], or for SSM
    layers conv and state, float32; for the hybrid family {"superblocks",
    "tail"} with rings of min(max_len, window) positions (``dtype``) and
    the RG-LRU's conv and h (float32).

    Under a mesh policy the attention caches without a window are split (a
    prefix, int8 with scales under ``kv_quant``, and a ``TAIL_LEN`` tail)
    and this rank holds its part of the tree (``cache_specs``): its data
    rank's batch/D rows, and 1/P of each prefix or ring, by kv heads or by
    sequence; the SSM state by heads, the conv caches whole."""
    check_mesh_arch(cfg, policy)
    device = resolve_device(device)
    d = policy.dp_size()
    if batch % d:
        raise ValueError(f"{batch} cache rows do not split over {d} data ranks")
    return _new_cache(cfg, batch // d, max_len, dtype, device, torch.zeros, policy)


def cache_rows(cache: dict, start: int, stop: int) -> dict:
    """Rows ``start:stop`` of every leaf of ``cache``, as views (a serving
    runner's slot rows; under ``layers`` and ``superblocks`` the batch dim
    follows the stacked layer dim)."""
    def rows(stacked):
        return (lambda c, _: c[:, start:stop]) if stacked else (lambda c, _: c[start:stop])

    return {k: _tree_map(rows(k in ("layers", "superblocks")), v) for k, v in cache.items()}


def _leaves(tree, name=None):
    """(name, leaf) of every leaf of a cache tree."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in _leaves(v, k)]
    if isinstance(tree, (list, tuple)):
        return [pair for v in tree for pair in _leaves(v, name)]
    return [] if tree is None else [(name, tree)]


_TAILS = ("tk", "tckv")  # the leaf that marks a split cache (GQA's, MLA's)


def has_tails(cache: dict) -> bool:
    """Whether any layer of ``cache`` is a split cache (with a tail)."""
    return any(name in _TAILS for name, _ in _leaves(cache))


def _split_caches(cache: dict) -> list:
    """Every layer's split attention cache (a dict with a tail), the
    stacked ones as views."""
    out = []

    def visit(tree, stacked):
        tail = [name for name in _TAILS if isinstance(tree, dict) and name in tree]
        if tail:
            n = tree[tail[0]].shape[0]
            out.extend([{k: c[i] for k, c in tree.items()} for i in range(n)] if stacked else [tree])
        elif isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, stacked or k in ("layers", "superblocks"))
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                visit(v, stacked)

    visit(cache, False)
    return out


def _chunk(cfg, policy: ParallelPolicy) -> tuple:
    """(m, P) of a sequence-sharded prefix, else (0, 1)."""
    if attn_lib.prefix_by_sequence(cfg, policy):
        return policy.model_rank(), policy.model_size()
    return 0, 1


def flush_tails(cache: dict, cfg, row: int, prefix_valid: int,
                policy: ParallelPolicy = LOCAL) -> None:
    """``attention.flush_tail`` of row ``row`` (of the rows this rank
    holds) in every layer's split cache: its tail written into its prefix
    at ``prefix_valid``, then zeroed."""
    chunk = _chunk(cfg, policy)
    for lc in _split_caches(cache_rows(cache, row, row + 1)):
        attn_lib.flush_tail(lc, prefix_valid, chunk=chunk)


def _write(lc: dict, new: dict) -> None:
    """Overwrite a layer's recurrent cache (or ring) whole."""
    for name, t in new.items():
        lc[name].copy_(t)


def _write_prefix(lc: dict, kt, vt, lo: int) -> None:
    """Write the prompt's k/v [b, kvh, s, hd] (positions 0..s-1) into the
    prefix positions ``lo`` .. that ``lc`` holds, zeros past the prompt, as
    the reference pads its prefill's cache; an int8 prefix takes the
    padded prefix quantized (``quantize_kv``), scales included; a split
    cache's tail is zeroed."""
    s_loc = lc["k"].shape[2]
    n = max(0, min(s_loc, kt.shape[2] - lo))
    for name, t in (("k", kt), ("v", vt)):
        if name + "_scale" in lc:
            padded = t.new_zeros(t.shape[:2] + (s_loc, t.shape[3]))
            padded[:, :, :n] = t[:, :, lo:lo + n]
            values, scales = attn_lib.quantize_kv(padded)
            lc[name].copy_(values)
            lc[name + "_scale"].copy_(scales)
        else:
            lc[name][:, :, :n] = t[:, :, lo:lo + n]
            lc[name][:, :, n:] = 0
    for name in ("tk", "tv"):
        if name in lc:
            lc[name].zero_()


def _write_ring(lc: dict, kt, vt, lo: int, ring: int) -> None:
    """Write a window's ring of ``ring`` slots whole from the prompt's k/v
    [b, kvh, s, hd]: the prompt and zeros past it when it is shorter than
    the ring, else its last ``ring`` positions, position t at slot t %
    ring. ``lc`` holds slots lo .. (a rank's chunk of a ring sharded by
    sequence, or all of it)."""
    s, n = kt.shape[2], lc["k"].shape[2]
    for name, t in (("k", kt), ("v", vt)):
        whole = (F.pad(t, (0, 0, 0, ring - s)) if s < ring
                 else torch.roll(t[:, :, s - ring:], s % ring, dims=2))
        lc[name].copy_(whole[:, :, lo:lo + n])


def _attn_prefill(p, h, cfg, positions, lc, policy: ParallelPolicy = LOCAL, sp: bool = False):
    """Causal self-attention over the prompt: through the flash kernel, or
    past a sliding window through ``_windowed_attention``. The prompt's k/v
    are written into the layer's cache ``lc`` {"k", "v", ...}: [b, kvh, S,
    hd] (``_write_prefix``); under a window the ring is written whole
    (``_write_ring``).

    Over a model group attention is ``attention._attn_tp``; this rank
    writes its kv heads of the prefix or ring, or under
    ``prefix_by_sequence`` its chunk of the positions (of the ring's slots)
    of every kv head."""
    chunks, lo = 1, 0
    if policy.model_size() > 1:
        out, xin, k, v = attn_lib._attn_tp(p, h, cfg, policy, True, sp, with_kv=True)
        if attn_lib.prefix_by_sequence(cfg, policy):
            k, v = attn_lib.kv_all_heads(p, xin, cfg, policy, positions)
            chunks = policy.model_size()
            lo = policy.model_rank() * lc["k"].shape[2]
    else:
        b, s, _ = h.shape
        q, k, v = attn_lib._project_qkv(p, h, cfg, positions)
        o = attn_lib.attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), cfg)
        out = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim_) @ p["wo"].to(h.dtype)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if cfg.window is None:
        _write_prefix(lc, kt, vt, lo)
    else:
        _write_ring(lc, kt, vt, lo, lc["k"].shape[2] * chunks)
    return out


def _mla_prefill(p, h, cfg, positions, lc, policy: ParallelPolicy = LOCAL, sp: bool = False):
    """MLA over the prompt (``attention.mla_forward``, over the model group
    ``_mla_tp``); its latent and RoPE key are written into the prefix
    positions that ``lc`` {"ckv", "kr", ...}: [b, S, ...] holds, zeros past
    the prompt: positions 0.., or over the model group this rank's chunk
    m S/P .. of the positions (every rank computed the whole sequence's
    latents). A split cache's tail is zeroed."""
    out, ckv, k_rope = attn_lib.mla_forward(p, h, cfg, policy, positions=positions,
                                            return_latents=True, seq_sharded=sp)
    s_loc = lc["ckv"].shape[1]
    lo = policy.model_rank() * s_loc
    n = max(0, min(s_loc, ckv.shape[1] - lo))
    for name, t in (("ckv", ckv), ("kr", k_rope)):
        lc[name][:, :n] = t[:, lo:lo + n]
        lc[name][:, n:] = 0
    for name in ("tckv", "tkr"):
        if name in lc:
            lc[name].zero_()
    return out


def _prefill_layer(x, lp, kind, cfg, positions, lc, policy: ParallelPolicy = LOCAL,
                   sp: bool = False):
    h = _norm(x, lp["ln1"], cfg)
    if kind == "ssm":
        y, new = ssm_lib.ssm_forward(lp["mixer"], h, cfg.d_model, cfg.ssm, return_cache=True,
                                     group=_mixer_group(policy), seq_sharded=sp)
        _write(lc, new)
        return x + y
    if kind == "rec":
        y, new = rglru_lib.rglru_forward(lp["mixer"], h, cfg.rglru, cfg.d_model, return_cache=True,
                                         seq_group=policy.model_group if sp else None)
        _write(lc, new)
    elif cfg.mla is not None:
        y = _mla_prefill(lp["attn"], h, cfg, positions, lc, policy, sp)
    else:
        y = _attn_prefill(lp["attn"], h, cfg, positions, lc, policy, sp)
    x = x + y
    h = _norm(x, lp["ln2"], cfg)
    return x + _ffn(h, lp, kind, cfg, policy=policy, sp=sp)


def _last_logits(h_last, params, cfg, policy: ParallelPolicy):
    """Logits [b, V] float32 of the last positions' hidden states [b, d]:
    over a model group that splits lm_head's vocab, each rank's columns
    all-gathered."""
    logits = layers.logits_last(h_last, params["lm_head"])
    if policy.model_size() > 1 and policy.splits(cfg.vocab):
        return gather_from(logits, -1, policy.model_group)
    return logits


def _prefix_room(cfg, cache, policy: ParallelPolicy) -> Optional[int]:
    """How many positions the cache's prefix holds (over the model group),
    or None for rings and recurrent states."""
    if cfg.window is not None:
        return None
    leaves = [t for name, t in _leaves(cache) if name in _SEQ_LEAVES]
    if not leaves:
        return None
    return leaves[0].shape[-2] * _chunk(cfg, policy)[1]


def lm_prefill(params, tokens, cfg, max_len: Optional[int] = None, *, cache=None,
               policy: ParallelPolicy = LOCAL):
    """Process a prompt, returning (last-token logits [b, V] float32, cache
    at len(prompt), zero past it). The prompt's k/v (or MLA latents) are
    written into ``cache`` when one is given (a cache of b rows, such as a
    serving runner's slot row, whose dtype rounds them once); otherwise
    into a new cache sized to ``max_len`` (defaults to the prompt length),
    as the reference's: attention leaves in the activation dtype, bf16
    under MLA, recurrent ones float32. Every leaf of the cache is written:
    the recurrent states and the sliding window's rings whole by their
    layers, the other attention leaves past the prompt zeroed. The MoE
    layers route the whole prompt at once, so its capacity (and what it
    drops) is the reference's for this prompt.

    Under a mesh policy ``params`` are this rank's shards, ``tokens`` its
    rows and the cache its part (``init_cache``): the blocks run
    tensor-parallel as ``lm_hidden``'s do (the residual stream this rank's
    slice of the sequence when ``policy.seq_sharded(s)``), each attention
    layer writes this rank's part of its prefix, and the logits of a
    vocab-split lm_head are gathered over the model group."""
    check_mesh_arch(cfg, policy)
    b, s = tokens.shape
    if cache is None:
        dtype = torch.bfloat16 if cfg.mla is not None else cfg.activation_dtype
        cache = _new_cache(cfg, b, max_len or s, dtype, tokens.device, torch.empty, policy)
    room = _prefix_room(cfg, cache, policy)
    if room is not None and s > room:
        raise ValueError(f"prompt of {s} tokens does not fit max_len={room}")
    sp = policy.seq_sharded(s)
    x = _embed_in(params, tokens, cfg, policy, sp)
    positions = torch.arange(s, device=x.device)
    for lp, lc, kind in _layers(cfg, params, cache):
        x = _prefill_layer(x, lp, kind, cfg, positions, lc, policy, sp)
    h = _norm(x, params["final_norm"], cfg)
    last = gather_from(h[:, -1:], 1, policy.model_group)[:, -1] if sp else h[:, -1]
    return _last_logits(last, params, cfg, policy), cache


def _decode_layer(x, lp, kind, lc, index, cfg, n_keys, policy, prefix_len):
    h = _norm(x, lp["ln1"], cfg)
    if kind == "ssm":
        y, _ = ssm_lib.ssm_decode(lp["mixer"], h, lc, cfg.d_model, cfg.ssm,
                                  group=_mixer_group(policy))
        return x + y
    if kind == "rec":
        y, _ = rglru_lib.rglru_decode(lp["mixer"], h, lc, cfg.rglru, cfg.d_model)
    elif cfg.mla is not None:
        y, _ = attn_lib.mla_decode(lp["attn"], h, lc, index, cfg, n_keys=n_keys, policy=policy,
                                   prefix_len=prefix_len)
    else:
        y, _ = attn_lib.attn_decode(lp["attn"], h, lc, index, cfg, n_keys=n_keys, policy=policy,
                                    prefix_len=prefix_len)
    x = x + y
    h = _norm(x, lp["ln2"], cfg)
    return x + _ffn(h, lp, kind, cfg, dropless=True, policy=policy)


def _check_tail_room(cfg, cache, policy, index, prefix_len, b: int) -> None:
    """Refuse a step that would write a row's tail outside it (each row's
    index within ``TAIL_LEN`` past its prefix length), where the host holds
    both (a tensor is not read back for it)."""
    room = _prefix_room(cfg, cache, policy)
    if room is None or not has_tails(cache):
        return
    rows = attn_lib.row_values(index, b)
    plen = attn_lib.row_values(room if prefix_len is None else prefix_len, b)
    if rows is None or plen is None:
        return
    for r, (i, p) in enumerate(zip(rows, plen)):
        if not 0 <= i - p < attn_lib.TAIL_LEN:
            raise ValueError(f"row {r}: index {i} is not within {attn_lib.TAIL_LEN} past its "
                             f"prefix length {p}: flush its tail first, or give its prefix_len")


def lm_decode_step(params, token, cache, index, cfg, *, policy: ParallelPolicy = LOCAL,
                   prefix_len=None):
    """One decode step. token: [b, 1] int; index: the number of tokens
    already in each row's cache, an int for all rows or one per row (the
    reference's vmap over slots, as a batch). Returns (logits [b, V]
    float32, cache), the cache updated in place. The MoE layers route the
    b tokens together with room for all b on every expert, so they drop
    none, as the reference's one-token steps drop none, for any b.

    A split cache (every one under a mesh policy) takes each row's new k/v
    into its tail at index - ``prefix_len``, where ``prefix_len`` (an int
    or one per row; the whole prefix by default) is the row's valid prefix
    length: the prompt's, plus ``TAIL_LEN`` for each flush since
    (``flush_tails``). Under a mesh policy ``params`` are this rank's
    shards, ``token`` its rows and the cache its part: attention over the
    model group by ``attention._attn_decode_split``, the MLPs
    tensor-parallel, the MoE's experts split over the group
    (``moe._moe_together``), the logits gathered over it."""
    check_mesh_arch(cfg, policy)
    _check_tail_room(cfg, cache, policy, index, prefix_len, token.shape[0])
    x = _embed_in(params, token, cfg, policy)
    idx, top = attn_lib.rows_tensor(index, token.shape[0], x.device)
    n_keys = top + 1
    for lp, lc, kind in _layers(cfg, params, cache):
        x = _decode_layer(x, lp, kind, lc, idx, cfg, n_keys, policy, prefix_len)
    h = _norm(x, params["final_norm"], cfg)
    return _last_logits(h[:, 0], params, cfg, policy), cache
