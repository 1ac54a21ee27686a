"""chatglm3-6b [dense] — arXiv:2406.12793 (hf-verified tier).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024; 2D-RoPE lineage:
rotary applied to half the head dim (rope_fraction=0.5); SwiGLU. Same
``CONFIG`` as ``repro.configs.chatglm3_6b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab=65024,
    head_dim=128,
    rope_fraction=0.5,
    mlp_act="swiglu",
)
