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

# Training on one 80 GB card (chip_smoke.py phase lm train,
# launch/profile_forward.py --lm-train): the training state (f32 params,
# gradients and both AdamW moments, 16 B a param) of all 28 layers is
# 149 GB, so the depth is cut to ONE_CARD_TRAIN_LAYERS at full width
# (2.68 B params, 42.9 GB of state); batches of ONE_CARD_TRAIN_BATCH
# sequences of ONE_CARD_TRAIN_SEQ tokens run as ONE_CARD_TRAIN_ACCUM
# micro-batches, remat on.
ONE_CARD_TRAIN_LAYERS = 4
ONE_CARD_TRAIN_SEQ = 1024
ONE_CARD_TRAIN_BATCH = 2
ONE_CARD_TRAIN_ACCUM = 2
