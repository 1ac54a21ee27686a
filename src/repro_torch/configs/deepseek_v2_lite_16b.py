"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf-verified tier).

27L d_model=2048 16H d_ff=1408 vocab=102400; MLA kv_lora=512 (decoupled
RoPE head 64, nope 128, v 128); MoE 64 routed top-6 + 2 shared; layer 0
dense (10944). (Full V2 has 160 routed experts; v2-lite has 64.)
Same ``CONFIG`` as ``repro.configs.deepseek_v2_lite_16b``.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,
    vocab=102400,
    rope_theta=10000.0,
    mlp_act="swiglu",
    mla=MLAConfig(kv_lora=512, dh_nope=128, dh_rope=64, dh_v=128),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        first_dense_ff=10944,
        norm_topk=True,
    ),
    notes="MLA latent KV cache: 576 B-equiv/token vs 4096 for GQA",
)
