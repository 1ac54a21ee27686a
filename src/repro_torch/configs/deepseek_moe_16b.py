"""deepseek-moe-16b [moe] — arXiv:2401.06066 (hf-verified tier).

28L d_model=2048 16H (MHA: kv=16) d_ff=1408 (per fine-grained expert)
vocab=102400; 2 shared + 64 routed experts, top-6; layer 0 dense
(first_dense_ff=10944 per the HF config).
Same ``CONFIG`` as ``repro.configs.deepseek_moe_16b``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    rope_theta=10000.0,
    mlp_act="swiglu",
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        first_dense_ff=10944,
        norm_topk=False,
    ),
    notes="fine-grained experts (1/4 width), 2 shared always-on",
)
