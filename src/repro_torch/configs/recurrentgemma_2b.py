"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (hf-verified tier).

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000; Griffin pattern
(rec, rec, attn) — RG-LRU recurrent blocks + local sliding-window (2048)
attention, head_dim=256; GeGLU MLP after every temporal block.
Same ``CONFIG`` as ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    window=2048,
    mlp_act="geglu",
    embed_scale=True,
    rglru=RGLRUConfig(d_rnn=2560, conv_kernel=4),
    block_pattern=("rec", "rec", "attn"),
    notes="long_500k runs: window-bounded KV + O(1) RG-LRU state",
)
