"""mamba2-370m [ssm] — arXiv:2405.21060 (unverified tier).

48L d_model=1024 (attention-free) d_ff=0 vocab=50280, ssm_state=128.
SSD (state-space duality) blocks; d_inner=2048, head_dim=64 -> 32 heads.
Same ``CONFIG`` as ``repro.configs.mamba2_370m``.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,     # d_inner / head_dim (informational; SSM derives its own)
    kv_heads=32,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    notes="attention-free; long_500k runs with O(1) recurrent state",
)
