"""LM models of the port: the dense, MoE, SSM and hybrid decoders, and whisper's encoder-decoder."""
from repro_torch.models.policy import LOCAL, ParallelPolicy
from repro_torch.models.transformer import (
    init_cache,
    init_lm_params,
    lm_decode_step,
    lm_hidden,
    lm_loss,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_prefill,
)
from repro_torch.models.whisper import (
    init_whisper_cache,
    init_whisper_params,
    whisper_decode_step,
    whisper_loss,
    whisper_params_from_numpy,
    whisper_params_to_numpy,
    whisper_prefill,
)

__all__ = [
    "LOCAL",
    "ParallelPolicy",
    "init_cache",
    "init_lm_params",
    "init_whisper_cache",
    "init_whisper_params",
    "lm_decode_step",
    "lm_hidden",
    "lm_loss",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "lm_prefill",
    "whisper_decode_step",
    "whisper_loss",
    "whisper_params_from_numpy",
    "whisper_params_to_numpy",
    "whisper_prefill",
]
