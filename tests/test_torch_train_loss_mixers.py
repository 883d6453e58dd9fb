"""The port's training loss and gradients against the JAX package on the
CPU (`test_torch_train_loss.py`'s checks, at its tolerances) for the archs
of the other block kinds and input modes: zamba2-2.7b (Mamba2 blocks and
the one shared attention block), xlstm-1.3b (mLSTM / sLSTM),
llama-3.2-vision-11b (cross attention over `enc`) and musicgen-large (frame
embeddings); remat on == off on each."""
import pytest

from test_torch_train_loss import check_against_jax, check_remat

pytestmark = pytest.mark.tier1

ARCHS = ("zamba2-2.7b", "xlstm-1.3b", "llama-3.2-vision-11b",
         "musicgen-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_against_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off(arch):
    check_remat(arch)
