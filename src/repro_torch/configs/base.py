"""Architecture configuration of the LM side: all five families of the reference.

Port of ``repro.configs.base.ArchConfig`` with its ``MLAConfig`` and
``EncoderConfig``, and of ``repro.models.moe.MoEConfig``,
``repro.models.ssm.SSMConfig`` and ``repro.models.rglru.RGLRUConfig``
(kept here, beside the config that holds them): the same fields and
defaults, so a config prints and compares like the reference's. The
families: dense, MoE (DeepSeek's fine-grained experts, with MLA or plain
attention), SSM (Mamba-2), hybrid (RecurrentGemma's RG-LRU and local
attention) and encoder-decoder (Whisper, served through the ``whisper_*``
entry points of ``models/whisper.py``), serially and over (data x model)
ranks; and the dry-run's shape grid (``ShapeConfig``, ``LM_SHAPES``,
``get_shape``, ``cell_supported``, ``input_specs``), the reference's cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# the families the port computes (every family of the reference)
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")

# the hybrid family's layer pattern when the config names none
DEFAULT_BLOCK_PATTERN = ("rec", "rec", "attn")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2): the compressed kv width,
    the per-head no-RoPE and RoPE query/key dims and the value dim."""
    kv_lora: int = 512
    dh_nope: int = 128
    dh_rope: int = 64
    dh_v: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; the conv/mel frontend is a stub: the inputs
    are precomputed frame embeddings [b, frames, d_model]."""
    n_layers: int = 4
    frames: int = 1500


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int          # per-expert FFN width
    n_shared: int = 0      # shared ("always-on") experts, deepseek-style
    first_dense_ff: int = 0  # layer-0 dense FFN width (0 = layer 0 is MoE too)
    norm_topk: bool = False
    capacity_factor: float = 1.25
    aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2's SSD mixer: state width, head dim, inner expansion, the
    depthwise conv's width, the scan's chunk and the B/C groups."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma's RG-LRU mixer: its width (0: d_model) and the
    depthwise conv's width."""
    d_rnn: int = 0
    conv_kernel: int = 4

    def width(self, d_model: int) -> int:
        return self.d_rnn or d_model


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    block_pattern: Tuple[str, ...] = ()   # hybrid pattern, e.g. (rec, rec, attn)
    encoder: Optional[EncoderConfig] = None
    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k is feasible (SSM / hybrid with bounded window)."""
        return self.family in ("ssm", "hybrid")

    @property
    def activation_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"activation dtype {self.dtype!r} is not one of {sorted(_DTYPES)}")
        return _DTYPES[self.dtype]

    @property
    def pattern(self) -> Tuple[str, ...]:
        """The hybrid family's repeating layer pattern."""
        return self.block_pattern or DEFAULT_BLOCK_PATTERN

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind sequence: ``dense`` layers (the
        encoder-decoder family's decoder layers too, as the reference counts
        them); for the MoE family ``moe`` layers after a ``dense0`` first
        layer when ``moe.first_dense_ff`` is set; ``ssm`` layers; for the
        hybrid family the pattern repeated and cut to ``n_layers``."""
        if self.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; known: {', '.join(PORTED_FAMILIES)}")
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.family == "hybrid":
            reps = -(-self.n_layers // len(self.pattern))
            return (self.pattern * reps)[: self.n_layers]
        if self.family == "moe":
            first = ("dense0",) if (self.moe and self.moe.first_dense_ff) else ("moe",)
            return first + ("moe",) * (self.n_layers - 1)
        return ("dense",) * self.n_layers

    def approx_params(self) -> int:
        """Analytic parameter count, as the reference counts it: an SSM
        layer's projections, conv and out_proj; a rec layer's RG-LRU mixer
        alone (the reference's count leaves out its MLP)."""
        d, v, hd = self.d_model, self.vocab, self.head_dim_
        total = 2 * v * d  # embed + lm_head
        for kind in self.layer_kinds():
            if kind == "ssm":
                s = self.ssm
                di = s.d_inner(d)
                total += d * (2 * di + 2 * s.d_state + s.n_heads(d))  # in_proj
                total += di * d + s.conv_dim(d) * s.conv_kernel + di
                continue
            if kind == "rec":
                w = self.rglru.width(d)
                total += 2 * d * w + 2 * w * w + w * d + 4 * w
                continue
            if self.mla is not None:
                m = self.mla
                total += d * self.n_heads * (m.dh_nope + m.dh_rope)
                total += d * (m.kv_lora + m.dh_rope)
                total += m.kv_lora * self.n_heads * (m.dh_nope + m.dh_v)
                total += self.n_heads * m.dh_v * d
            else:
                total += d * self.n_heads * hd + 2 * d * self.kv_heads * hd
                total += self.n_heads * hd * d
            if kind == "moe":
                mo = self.moe
                total += d * mo.n_experts  # router
                total += mo.n_experts * 3 * d * mo.d_expert
                total += mo.n_shared * 3 * d * mo.d_expert
            elif kind == "dense0":
                total += 3 * d * self.moe.first_dense_ff
            else:
                total += (3 if self.mlp_act in ("swiglu", "geglu") else 2) * d * self.d_ff
        return total

    def approx_active_params(self) -> int:
        """Parameters a token runs through (MoE: the routed top-k and the
        shared experts only)."""
        if self.moe is None:
            return self.approx_params()
        mo = self.moe
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_expert
        return self.approx_params() - self.layer_kinds().count("moe") * inactive


# ---------------------------------------------------------------------------
# The dry-run's shape grid (``launch/dryrun.py``): the reference's cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether this (arch x shape) dry-run cell runs, and why not if not:
    the reference's rule, long_500k only for the families whose attention
    is bounded (``ArchConfig.sub_quadratic``)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full-attention arch: O(S^2) at 524k ctx — skipped per assignment"
    return True, ""


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    """{name: (shape, dtype)} of every model input of this cell (the
    reference's ``ShapeDtypeStruct`` stand-ins as shapes and torch
    dtypes)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    frames = {"frames": ((b, arch.encoder.frames, arch.d_model), arch.activation_dtype)} \
        if arch.family == "encdec" else {}
    if shape.kind == "train":
        return {"tokens": ((b, s), i32), "targets": ((b, s), i32), **frames}
    if shape.kind == "prefill":
        return {"tokens": ((b, s), i32), **frames}
    # decode: one token per sequence + cache of length seq_len
    return {"token": ((b, 1), i32), "index": ((), i32)}
