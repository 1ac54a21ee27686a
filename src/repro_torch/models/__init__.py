"""LM models of the port, for serving: the dense, MoE, SSM and hybrid decoder families."""
from repro_torch.models.transformer import (
    init_cache,
    init_lm_params,
    lm_decode_step,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_prefill,
)

__all__ = [
    "init_cache",
    "init_lm_params",
    "lm_decode_step",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "lm_prefill",
]
