"""The SSM and hybrid families' served path on the card (``cuda`` marker).

Reduced mamba2-370m and a 5-layer recurrentgemma-2b (one superblock and a
tail of two rec layers), prefill and one decode step through the RMSNorm
and flash-attention kernels against the same through their plain versions,
with the kernels' launch counts. They import no JAX, skip without a card,
and run on the machine with one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_recurrent_card.py

Gate: the logits within 3e-2 of max|ref| (bf16 activations, a rounding
flip of one of which propagates through every later layer).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention as flash_pkg
import repro_torch.kernels.rmsnorm as rms_pkg
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref
from repro_torch.models import init_lm_params, lm_decode_step, lm_prefill
from repro_torch.models.transformer import flash_per_prefill, norms_per_forward

GATE = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers,s", [("mamba2-370m", 2, 37), ("recurrentgemma-2b", 5, 12),
                                             ("recurrentgemma-2b", 5, 37)],
                         ids=["mamba2", "hybrid-flash", "hybrid-windowed"])
def test_reduced_prefill_and_decode_on_card_match_plain(cuda, arch, n_layers, s, monkeypatch):
    cfg = dataclasses.replace(reduced(get_arch(arch)), n_layers=n_layers)
    params = init_lm_params(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda,
                            serving=True)
    tokens = torch.from_numpy(np.random.default_rng(60).integers(1, cfg.vocab, size=(1, s))).to(cuda)

    def run():
        logits, cache = lm_prefill(params, tokens, cfg, max_len=40)
        step, _ = lm_decode_step(params, torch.argmax(logits, -1)[:, None], cache, s, cfg)
        return logits, step

    before = (rmsnorm_cuda.launches, flash_attention_cuda.launches)
    got = run()
    assert rmsnorm_cuda.launches - before[0] == 2 * norms_per_forward(cfg)
    assert flash_attention_cuda.launches - before[1] == flash_per_prefill(cfg, s)
    monkeypatch.setattr(rms_pkg, "rmsnorm", lambda x, w, eps=1e-6: rmsnorm_ref(x, w, eps))
    monkeypatch.setattr(flash_pkg, "flash_attention", flash_attention_ref)
    want = run()
    for g, w, what in zip(got, want, ("prefill", "decode")):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert torch.isfinite(g).all() and err <= GATE * scale, f"{what}: {err:.3e} vs {scale:.3e}"
