"""The port's LM train step on the CPU: remat's variants, the kernels'
launches a training pass, two AdamW steps against the reference's
``make_train_step``, and checkpoints of LM trees (a hybrid's tail list, an
MoE's ``layer0``) read by both packages. Gates where used;
``lm_train_common`` draws the params and tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.models.policy import LOCAL as JLOCAL
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import checkpoint as jckpt
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.kernels import flash_attention as flash_pkg
from repro_torch.kernels import rmsnorm as rms_pkg
from repro_torch.models import LOCAL, ParallelPolicy, lm_loss, lm_params_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step, zeros_like_tree
from lm_train_common import (
    DECODER_IDS, SEQ, StandInGroup, _batch, _jbatch, _leaf_pairs, _lm_tree, _np_tree,
    _port_loss_and_grads, _tbatch, cfgs, one_process_model_group,
)


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v2-lite-16b", "recurrentgemma-2b"])
def test_remat_on_off_and_dots_give_the_same_gradients(arch):
    jcfg, cfg = cfgs(arch, "float32")
    cfg = dataclasses.replace(cfg, n_layers=5) if cfg.family == "hybrid" else cfg  # a tail of 2
    tree = _np_tree(jax.eval_shape(lambda: jtf.init_lm_params(
        jax.random.PRNGKey(0), dataclasses.replace(jcfg, n_layers=cfg.n_layers))), 8)
    tb = _tbatch(*_batch(cfg.vocab, 2, 9))
    runs = {name: _port_loss_and_grads(cfg, tree, tb, policy)
            for name, policy in (("off", ParallelPolicy(remat=False)), ("on", LOCAL),
                                 ("dots", ParallelPolicy(remat_policy="dots")))}
    for name in ("on", "dots"):
        assert runs[name][0] == runs["off"][0]
        for leaf, ref, got in _leaf_pairs(runs["off"][2], runs[name][2]):
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7, msg=f"remat {name}{leaf}")
    with pytest.raises(ValueError, match="remat_policy"):
        ParallelPolicy(remat_policy="everything")


def test_a_policy_over_a_mesh_is_the_distributed_slice():
    """A policy over process groups runs every decoder family: dense and
    MoE, MLA among them (``tests/test_torch_dist_lm.py``), SSM and hybrid
    (``tests/test_torch_dist_recurrent.py``), and serves them from split
    caches, int8 ones with ``kv_quant`` (``tests/test_torch_dist_serve_lm.py``).
    Over a model group of more than one rank the encoder-decoder family
    runs (``whisper_loss`` on a rank's shards of a model group of 2, taken
    to its end in one process; ``tests/test_torch_dist_whisper.py`` holds
    its values), and MLA and SSM heads that the group does not divide are
    refused; a mesh without a group for an axis is refused."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import init_whisper_params, whisper_loss
    from repro_torch.models.transformer import check_mesh_arch, shard_params

    mesh = {"data": StandInGroup(1), "model": StandInGroup(2)}
    policy = ParallelPolicy(mesh=mesh)
    assert policy.distributed and policy.model_size() == 2 and policy.dp_size() == 1
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        assert check_mesh_arch(reduced(get_arch(arch)), policy) is None
    three = ParallelPolicy(mesh={"data": StandInGroup(1), "model": StandInGroup(3)})
    with pytest.raises(ValueError, match="MLA heads do not split over 3 model ranks"):
        lm_loss({}, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                reduced(get_arch("deepseek-v2-lite-16b")), three)
    with pytest.raises(ValueError, match="8 SSM heads do not split over 3 model ranks"):
        lm_loss({}, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                reduced(get_arch("mamba2-370m")), three)
    whisper = dataclasses.replace(reduced(get_arch("whisper-tiny")), dtype="float32")
    assert check_mesh_arch(whisper, policy) is None
    with one_process_model_group(2) as group_mesh:
        two = ParallelPolicy(mesh=group_mesh)
        whole = init_whisper_params(whisper, generator=torch.Generator().manual_seed(0),
                                    device="cpu")
        f, d = whisper.encoder.frames, whisper.d_model
        batch = {"frames": torch.randn(2, f, d), "tokens": torch.ones(2, 4, dtype=torch.long),
                 "targets": torch.ones(2, 4, dtype=torch.long)}
        xent, _ = whisper_loss(shard_params(whole, whisper, two), batch, whisper, two)
        assert xent.shape == () and torch.isfinite(xent)
    from repro_torch.models import init_cache

    quant = ParallelPolicy(mesh=mesh, kv_quant=True)
    cache = init_cache(reduced(get_arch("chatglm3-6b")), 2, 16, device="cpu", policy=quant)
    leaves = cache["layers"]
    assert leaves["k"].dtype == leaves["v"].dtype == torch.int8
    assert leaves["k_scale"].dtype == leaves["v_scale"].dtype == torch.bfloat16
    assert leaves["tk"].dtype == torch.bfloat16 and leaves["k"].shape[1:] == (2, 1, 16, 16)
    with pytest.raises(ValueError, match="no group for axes"):
        ParallelPolicy(mesh={"model": StandInGroup(2)})
    x = torch.ones(2, 3, 4)
    assert LOCAL.shard_act(x) is x and LOCAL.shard(x, "data") is x
    assert LOCAL.remat and LOCAL.remat_policy is None and not LOCAL.distributed


@pytest.mark.parametrize("arch", DECODER_IDS)
def test_train_launches_counts_each_kernel_call_of_a_training_pass(arch, monkeypatch):
    """On the card each call of the two kernel wrappers is one launch; on
    the CPU the same calls reach the package attributes, counted here, in
    the forward and in remat's recompute (the backward calls neither)."""
    jcfg, cfg = cfgs(arch, "float32")
    tree = _lm_tree(jcfg, 10)
    calls = {"rmsnorm": 0, "flash": 0}

    def counted(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(rms_pkg, "rmsnorm", counted(rms_pkg.rmsnorm, "rmsnorm"))
    monkeypatch.setattr(flash_pkg, "flash_attention", counted(flash_pkg.flash_attention, "flash"))
    _port_loss_and_grads(cfg, tree, _tbatch(*_batch(cfg.vocab, 2, 11)), LOCAL)
    assert calls == ttf.train_launches(cfg, SEQ), arch
    assert calls["rmsnorm"] > 0 and (calls["flash"] > 0) == (cfg.family not in ("ssm", "hybrid"))



# ---------------------------------------------------------------------------
# the train step, AdamW and checkpoints over LM trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum", [("gemma-7b", 1), ("deepseek-moe-16b", 2)])
def test_two_adamw_steps_match_the_reference_train_step(arch, accum):
    jcfg, cfg = cfgs(arch, "float32")
    tree = _lm_tree(jcfg, 12)
    jstep = jax.jit(jmake_train_step(lambda p, b: jtf.lm_loss(p, b, jcfg, JLOCAL),
                                     JAdamWConfig(lr=1e-3, grad_clip=0.5), grad_accum=accum))
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), AdamWConfig(lr=1e-3, grad_clip=0.5),
                           grad_accum=accum)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jinit_opt_state(jparams)
    params = lm_params_from_numpy(tree, device="cpu")
    opt = init_opt_state(params)
    for i in range(2):
        tokens, targets = _batch(cfg.vocab, 4, 20 + i)
        jparams, jopt, jm = jstep(jparams, jopt, _jbatch(tokens, targets))
        params, opt, m = step(params, opt, _tbatch(tokens, targets))
        for k in ("loss", "xent", "aux", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-10), (i, k)
    # AdamW divides each entry's gradient by its own root mean square, so an
    # entry whose gradient is float32 noise steps by up to lr either way:
    # params are held to 1e-4 relative plus 5% of lr
    for name, ref, got in _leaf_pairs(jax.tree.map(np.asarray, jparams), params):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=0.05 * 1e-3, err_msg=name)
    for name, ref, got in _leaf_pairs(jax.tree.map(np.asarray, jopt["mu"]), opt["mu"]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-8, err_msg=name)


def test_lm_checkpoints_use_the_reference_names_both_ways(tmp_path):
    """A hybrid tree (the tail's list) and an MoE one (``layer0``) saved by
    the port read back by the reference, and the reference's by the port."""
    for arch in ("recurrentgemma-2b", "deepseek-v2-lite-16b"):
        jcfg, cfg = cfgs(arch, "float32")
        tree = _lm_tree(jcfg, 13)
        params = lm_params_from_numpy(tree, device="cpu")
        state = {"params": params, "opt": init_opt_state(params)}
        tckpt.save(str(tmp_path / arch), 3, state)
        jparams = jax.tree.map(jnp.asarray, tree)
        jstate = {"params": jparams, "opt": jinit_opt_state(jparams)}
        back, step, _ = jckpt.restore(str(tmp_path / arch), jax.eval_shape(lambda: jstate))
        assert step == 3
        for name, ref, got in _leaf_pairs(tree, back["params"]):
            np.testing.assert_array_equal(np.asarray(got), ref, err_msg=name)
        jckpt.save(str(tmp_path / f"{arch}-j"), 5, jstate)
        fresh = {"params": zeros_like_tree(params), "opt": init_opt_state(params)}
        assert tckpt.restore_into(str(tmp_path / f"{arch}-j"), fresh)[0] == 5
        for name, ref, got in _leaf_pairs(tree, fresh["params"]):
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
