"""gemma-7b [dense] — arXiv:2403.08295 (hf-verified tier).

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000; GeGLU; head_dim=256;
embeddings scaled by sqrt(d). (The 2b sibling uses MQA; 7b is full MHA.)
Same ``CONFIG`` as ``repro.configs.gemma_7b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    mlp_act="geglu",
    embed_scale=True,
)
