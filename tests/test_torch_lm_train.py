"""The port's LM training path against the JAX reference's, on the CPU:
the token pipeline, and the loss and its gradients of the dense archs and
of whisper. The gates are ``lm_train_common``'s (its docstring); token
batches are bitwise the reference's. The MoE, SSM and hybrid archs are in
``test_torch_lm_train_families.py``, the train step in
``test_torch_lm_train_step.py``.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.data import ArrayStore as JStore
from repro.data import StoreTokens as JStoreTokens
from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.configs import DENSE_IDS
from repro_torch.data.store import ArrayStore
from repro_torch.data.tokens import StoreTokens, SyntheticTokens
from lm_train_common import BF16, F32_GRAD, _grads_close, check_lm_loss, check_whisper_loss


@pytest.mark.parametrize("seed,host_slice", [(0, (0, 1)), (3, (1, 2)), (7, (2, 4))])
def test_synthetic_tokens_are_the_references_bitwise(seed, host_slice):
    args = (1000, 8, 16)
    mine, ref = (cls(*args, seed=seed, host_slice=host_slice)
                 for cls in (SyntheticTokens, JSyntheticTokens))
    for step in (0, 1, 17):
        a, b = mine.batch(step), ref.batch(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticTokens(1000, 6, 16, host_slice=(0, 4))


def test_store_tokens_are_the_references_bitwise():
    rows, row_len = 5, 48
    data = np.random.default_rng(4).integers(0, 500, size=(rows, row_len)).astype(np.int32)
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "toks")
        store = ArrayStore.create(root, (rows, row_len), "i4", (1, row_len))
        for i in range(rows):
            store.write_chunk((i, 0), data[i: i + 1])
        assert JStore.open(root).shape == (rows, row_len)
        mine = StoreTokens(root, seq_len=16, local_batch=3, seed=2)
        ref = JStoreTokens(root, seq_len=16, local_batch=3, seed=2)
        for step in (0, 5):
            a, b = mine.batch(step), ref.batch(step)
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(a[k], b[k])
        with pytest.raises(ValueError, match="no window"):
            StoreTokens(root, seq_len=48, local_batch=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_IDS)
def test_lm_loss_and_gradients_match(arch, dtype, monkeypatch):
    check_lm_loss(arch, dtype, monkeypatch)


def test_gradient_gate_refuses_zero_and_missing_leaves(monkeypatch):
    jgrads, grads = check_lm_loss("gemma-7b", "float32", monkeypatch)
    missing = dict(grads, layers=dict(grads["layers"], attn=dict(grads["layers"]["attn"], wq=None)))
    with pytest.raises(AssertionError, match="wq: no gradient"):
        _grads_close(jgrads, missing, F32_GRAD, "")
    zero = dict(grads, final_norm=torch.zeros_like(grads["final_norm"]))
    with pytest.raises(AssertionError, match="final_norm: all zeros"):
        _grads_close(jgrads, zero, F32_GRAD, "")
    off = dict(grads, embed=grads["embed"] * 1.01)
    with pytest.raises(AssertionError, match="embed: max"):
        _grads_close(jgrads, off, F32_GRAD, "")


@pytest.mark.parametrize("dtype,rel", [("float32", F32_GRAD), ("bfloat16", BF16)])
def test_whisper_loss_gradients_match(dtype, rel):
    check_whisper_loss(dtype, rel)
