"""minitron-8b [dense] — arXiv:2407.14679 (hf-verified tier).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000; pruned nemotron:
squared-ReLU non-gated MLP, rope partial per nemotron (fraction 0.5). Same
``CONFIG`` as ``repro.configs.minitron_8b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=16384,
    vocab=256000,
    head_dim=128,
    rope_fraction=0.5,
    mlp_act="relu2",
)
