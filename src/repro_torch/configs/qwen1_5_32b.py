"""qwen1.5-32b [dense] — hf:Qwen/Qwen1.5-32B family (hf-verified tier).

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064; QKV bias; SwiGLU;
rope theta 1e6. Same ``CONFIG`` as ``repro.configs.qwen1_5_32b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
)
