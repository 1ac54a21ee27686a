"""chameleon-34b [vlm] — arXiv:2405.09818 (unverified tier).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (incl. VQ image
tokens). Early-fusion: image tokens are ordinary vocabulary entries, so the
backbone is a dense decoder; the VQ tokenizer frontend is a stub (token ids
arrive pre-fused). QK-norm per the chameleon recipe. Same ``CONFIG`` as
``repro.configs.chameleon_34b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=22016,
    vocab=65536,
    head_dim=128,
    qk_norm=True,
    mlp_act="swiglu",
    notes="early-fusion VQ image tokens; frontend stubbed as token ids",
)
