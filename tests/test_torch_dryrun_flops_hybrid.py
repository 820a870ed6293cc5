"""recurrentgemma-9b's dry-run matmul FLOPs, held to the JAX dry-run's
compiled HLO: ``tests/test_torch_dryrun_flops.py``'s comparison (SMOKE,
B 1, S 1024, one device) for the hybrid stack, in a file (a worker) of
its own. Prefill, decode and train are equal; the train step since the
port remats each whole period of the pattern as one unit and leaves the
tail layers alone, as the reference's scan body does.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_dryrun_cases import jax_flops, port_flops  # noqa: E402,F401


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dot_flops_equal_the_jax_dry_run(jax_flops, kind):  # noqa: F811
    want = jax_flops("recurrentgemma-9b", kind)
    assert want > 0
    assert port_flops("recurrentgemma-9b", kind) == pytest.approx(
        want, rel=1e-12, abs=0)


def test_recurrentgemma_tail_is_not_rematerialised(jax_flops):  # noqa: F811
    """The repair: five SMOKE layers are one period of (rglru, rglru,
    local_attn), remat'd as a unit, and two tail layers outside it; a
    remat of every layer alone (the port before) recomputes the tail's
    two layers, 117,440,512 FLOPs (+4.24%) more than the reference."""
    cfg = get_smoke_config("recurrentgemma-9b")
    assert tfm.layer_plan(cfg) == (1, ("rglru", "rglru"))
    want = jax_flops("recurrentgemma-9b", "train")
    assert port_flops("recurrentgemma-9b", "train") == want
