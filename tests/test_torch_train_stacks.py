"""The port's training forward against the JAX package's for the MoE,
hybrid, recurrent and encoder-decoder SMOKE archs, on the CPU: loss,
``ce``, ``lb_loss`` and ``z_loss``, and every parameter leaf's gradient
(through the MoE dispatch, the RG-LRU doubling scan, the SSD chunk loop
and the encoder), with ``torch_train_cases``' tolerances.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from torch_train_cases import (one_thread,  # noqa: E402, F401
                               check_loss_and_grads)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_moe_loss_aux_and_grads_equal_jax(arch):
    """The loss is ce + 0.01 lb_loss + 0.001 z_loss, both aux losses
    summed over the MoE layers and non-zero."""
    aux = check_loss_and_grads(arch, 2, 40)
    assert aux["lb_loss"].item() > 0 and aux["z_loss"].item() > 0


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_recurrent_and_encdec_loss_and_grads_equal_jax(arch):
    check_loss_and_grads(arch, 2, 40)
