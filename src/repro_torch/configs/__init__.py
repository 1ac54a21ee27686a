"""Architecture registry of the port: the dense LM configs beside the FNO.

``ARCH_IDS`` lists the reference's ten LM architectures; the port serves
the dense ones (``DENSE_IDS``). ``get_arch`` of any other raises and names
the ROADMAP item that ports its family. ``FNO_IDS`` are the paper's FNO
configs (Navier-Stokes and Sleipner), as the reference registers them;
``get_fno`` returns one's ``(CONFIG, SHAPES)``.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import NOT_PORTED, ArchConfig

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

FNO_IDS = ("fno-ns3d", "fno-sleipner", "fno-sleipner-2d")


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    if name not in DENSE_IDS:
        raise NotImplementedError(f"arch {name!r}: {NOT_PORTED}")
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
    ``reduced`` builds it for the dense family."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: {NOT_PORTED}")
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        kv_heads=max(1, min(cfg.kv_heads, 2)),
        d_ff=128,
        vocab=512,
        head_dim=16,
        window=16 if cfg.window else None,
    )


__all__ = ["ARCH_IDS", "DENSE_IDS", "FNO_IDS", "ArchConfig", "get_arch", "get_fno", "reduced"]
