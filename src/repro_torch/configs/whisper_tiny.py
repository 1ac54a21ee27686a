"""whisper-tiny [audio] — arXiv:2212.04356 (unverified tier).

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865; encoder-decoder with conv
frontend STUBBED (the inputs are precomputed frame embeddings, 1500
frames). LayerNorm + GELU + sinusoidal positions. Copy of
``repro.configs.whisper_tiny``.
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    kv_heads=6,
    d_ff=1536,
    vocab=51865,
    qkv_bias=True,
    rope_fraction=0.0,   # sinusoidal positions, no RoPE
    mlp_act="gelu",
    norm="ln",
    norm_eps=1e-5,
    encoder=EncoderConfig(n_layers=4, frames=1500),
    notes="frontend stub per assignment; decoder positions sinusoidal",
)
