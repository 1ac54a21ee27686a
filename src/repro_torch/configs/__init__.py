"""Architecture registry of the port: the LM configs beside the FNO.

``ARCH_IDS`` lists the reference's ten LM architectures, all ported: the
dense ones (``DENSE_IDS``), the MoE ones (``MOE_IDS``) and the recurrent
ones (``RECURRENT_IDS``: the SSM and hybrid families), together
``SERVED_IDS``, which the token engine serves; and the encoder-decoder one
(``ENCDEC_IDS``: whisper-tiny), which the ``whisper_*`` entry points serve,
as in the reference. ``FNO_IDS`` are the paper's FNO
configs (Navier-Stokes and Sleipner), as the reference registers them;
``get_fno`` returns one's ``(CONFIG, SHAPES)``.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    ArchConfig, EncoderConfig, MLAConfig, MoEConfig, RGLRUConfig, SSMConfig,
)

ARCH_IDS = (
    "deepseek-moe-16b",
    "deepseek-v2-lite-16b",
    "mamba2-370m",
    "whisper-tiny",
    "chameleon-34b",
    "qwen1.5-32b",
    "chatglm3-6b",
    "gemma-7b",
    "minitron-8b",
    "recurrentgemma-2b",
)

DENSE_IDS = ("chameleon-34b", "qwen1.5-32b", "chatglm3-6b", "gemma-7b", "minitron-8b")
MOE_IDS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
RECURRENT_IDS = ("mamba2-370m", "recurrentgemma-2b")
SERVED_IDS = DENSE_IDS + MOE_IDS + RECURRENT_IDS
ENCDEC_IDS = ("whisper-tiny",)

FNO_IDS = ("fno-ns3d", "fno-sleipner", "fno-sleipner-2d")


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    module = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def get_fno(name: str):
    """``(CONFIG, SHAPES)`` of the FNO config ``name`` (one of ``FNO_IDS``)."""
    if name not in FNO_IDS:
        raise KeyError(f"unknown FNO config {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG, mod.SHAPES


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests, as the reference's
    ``reduced`` builds it."""
    changes = dict(
        n_layers=3 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        kv_heads=max(1, min(cfg.kv_heads, 2)),
        d_ff=0 if cfg.family == "ssm" else 128,
        vocab=512,
        head_dim=16,
        window=16 if cfg.window else None,
    )
    if cfg.moe:
        changes["moe"] = MoEConfig(
            n_experts=8,
            top_k=2,
            d_expert=32,
            n_shared=cfg.moe.n_shared and 1,
            first_dense_ff=64 if cfg.moe.first_dense_ff else 0,
            norm_topk=cfg.moe.norm_topk,
        )
    if cfg.mla:
        changes["mla"] = MLAConfig(kv_lora=32, dh_nope=16, dh_rope=8, dh_v=16)
        changes["head_dim"] = None
    if cfg.ssm:
        changes["ssm"] = SSMConfig(d_state=16, head_dim=16, chunk=16)
        changes["head_dim"] = None
        changes["n_heads"] = 8
        changes["kv_heads"] = 8
    if cfg.rglru:
        changes["rglru"] = RGLRUConfig(d_rnn=0, conv_kernel=4)
    if cfg.encoder:
        changes["encoder"] = EncoderConfig(n_layers=2, frames=12)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCH_IDS", "DENSE_IDS", "ENCDEC_IDS", "FNO_IDS", "MOE_IDS", "RECURRENT_IDS",
           "SERVED_IDS", "ArchConfig", "EncoderConfig", "MLAConfig", "MoEConfig", "RGLRUConfig",
           "SSMConfig", "get_arch", "get_fno", "reduced"]
