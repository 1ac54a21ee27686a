"""Architecture configuration of the LM side, for the dense family.

Port of ``repro.configs.base.ArchConfig``: the same fields and defaults,
so a config prints and compares like the reference's. The port serves the
dense family only; the fields of the other families (``moe``, ``mla``,
``ssm``, ``rglru``, ``encoder``, ``block_pattern``) are kept so that the
field lists match, and every method that would need them raises and names
ROADMAP Queue 1 item 5, where those families wait.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 5: the rest of the LLM family)"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    window: Optional[int] = None      # sliding-window local attention
    mlp_act: str = "swiglu"
    embed_scale: bool = False         # gemma: x *= sqrt(d)
    norm: str = "rms"                 # rms | ln
    norm_eps: float = 1e-6
    moe: Optional[object] = None
    mla: Optional[object] = None
    ssm: Optional[object] = None
    rglru: Optional[object] = None
    block_pattern: Tuple[str, ...] = ()
    encoder: Optional[object] = None
    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"activation dtype {self.dtype!r} is not one of {sorted(_DTYPES)}")
        return _DTYPES[self.dtype]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind sequence (the dense family only)."""
        if self.family != "dense":
            raise NotImplementedError(f"family {self.family!r}: {NOT_PORTED}")
        return ("dense",) * self.n_layers

    def approx_params(self) -> int:
        """Analytic parameter count, as the reference counts it."""
        d, v, hd = self.d_model, self.vocab, self.head_dim_
        per_layer = d * self.n_heads * hd + 2 * d * self.kv_heads * hd
        per_layer += self.n_heads * hd * d
        per_layer += (3 if self.mlp_act in ("swiglu", "geglu") else 2) * d * self.d_ff
        return 2 * v * d + len(self.layer_kinds()) * per_layer
