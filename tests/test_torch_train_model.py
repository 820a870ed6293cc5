"""The port's training forward against the JAX package's, on the CPU:
``api.loss_fn``'s loss, ``ce`` and every parameter leaf's gradient for
the dense archs and the vlm (``torch_train_cases``' tolerances; the other
archs are in ``test_torch_train_stacks.py``), S = 600 (two cross-entropy
chunks, the second padded), the one-shot attention branch and granite's
padded vocab rows. fp32 SMOKE configs, JAX params moved over by
``repro_torch.convert``; numpy inputs from a seed.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime.trainer import loss_and_grads  # noqa: E402
from torch_train_cases import (one_thread, batch,  # noqa: E402, F401
                               check_loss_and_grads, pair, torch_batch)

ATTN_ARCHS = ("qwen2.5-3b", "yi-6b", "qwen1.5-4b", "granite-3-2b",
              "internvl2-2b")


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_loss_and_grads_equal_jax(arch):
    """The dense archs and the vlm (its 4 frontend embeddings carry no
    loss); granite's vocab 250 pads to 256, whose padded rows must get no
    probability and no head gradient."""
    check_loss_and_grads(arch, 2, 40)


def test_loss_over_two_ce_chunks_equals_jax():
    """S = 600: the cross-entropy runs over a 512-token chunk and a second
    one padded with 424 masked labels; attention over 3 q chunks of 256 and
    2 kv chunks of 512, both padded."""
    check_loss_and_grads("qwen2.5-3b", 1, 600)


def test_granite_padded_vocab_rows_get_no_gradient():
    jc, tc, jp, tp = pair("granite-3-2b")
    assert tc.vocab == 250 and tfm.padded_vocab(tc.vocab) == 256
    _, _, grads = loss_and_grads(tc, tp, torch_batch(batch(jc, 2, 16)))
    w = grads["embed"] if tc.tie_embeddings else grads["head"].T
    assert (w[250:] == 0).all() and (w[:250] != 0).any()


def test_unpadded_one_shot_attention_equals_jax():
    """flash_chunking off: the one-shot softmax branch in both packages."""
    check_loss_and_grads("qwen2.5-3b", 2, 40, flash_chunking=False)
