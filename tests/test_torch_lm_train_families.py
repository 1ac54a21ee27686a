"""The port's ``lm_loss`` and its gradients against the JAX reference's on
the CPU for the MoE (dense ``layer0``, MLA, the load-balance loss), SSM and
hybrid (superblocks and a tail) archs, at float32 and bf16; the gates are
``lm_train_common``'s (its docstring)."""
import pytest

from repro_torch.configs import MOE_IDS, RECURRENT_IDS
from lm_train_common import check_lm_loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_IDS + RECURRENT_IDS)
def test_lm_loss_and_gradients_match(arch, dtype, monkeypatch):
    check_lm_loss(arch, dtype, monkeypatch)
