"""Context parallelism's recurrent mixers and MoE held to the JAX
package's, on the CPU over gloo: the sequence split over ``model``, each
rank on its block of every row, in spawned worlds of 2 and 4 gloo ranks
(the ranks are ``tests/torch_cp_ranks.py``, which imports no jax); each
rank's rows joined and held to the JAX function on the whole sequence:
``rglru_apply`` and ``ssm_apply`` (the sequence gathered, the scan whole,
the state at a ``length``) and ``moe_apply`` (dbrx-132b SMOKE, 4 experts
split over the ranks, at B 1 S 36, one dispatch group spanning every
rank's block, and B 2 S 64, groups of 4 inside the blocks; the aux
losses within rtol 1e-5). Cases and tolerances: ``tests/torch_cp_cases.py``
(atol = rtol = 2e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax.numpy as jnp  # noqa: E402

from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from torch_cp_cases import (F32, MOE_SHAPES, WORLDS, block_of,  # noqa: E402
                            bundle_and_worlds, joined, to_jax)
from torch_train_cases import one_thread, results  # noqa: E402,F401


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(inputs, worlds): what the ranks read, their results."""
    return bundle_and_worlds(tmp_path_factory.mktemp("cp_moe"),
                             ("mixers", "moe"))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b"])
def test_mixers_equal_jax(bundle, n, arch):
    res = results(bundle[1][n], "mixers")
    m = bundle[0]["mixers"][arch]
    jc, _, _ = block_of(arch, "rglru" if arch[0] == "r" else "ssm")
    fn = jgriffin.rglru_apply if arch[0] == "r" else jssm.ssm_apply
    p, x = to_jax(m["p"]), jnp.asarray(m["x"].numpy())
    want = fn(jc, p, x)
    want2, state = fn(jc, p, x, return_state=True,
                      length=jnp.asarray(m["length"].numpy()))
    np.testing.assert_allclose(joined(res, arch, 0), np.asarray(want),
                               **F32)
    np.testing.assert_allclose(joined(res, arch, 1), np.asarray(want2),
                               **F32)
    for r in res:
        for name, t in r[arch][2].items():
            np.testing.assert_allclose(t, np.asarray(state[name]), **F32)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("shape", list(MOE_SHAPES))
def test_moe_equals_jax(bundle, n, shape):
    """B 1 S 36: 36 rows do not split into 32 dispatch groups, so one group
    holds them all and its capacity ranks run across every rank's block;
    B 2 S 64: 32 groups of 4 rows inside the blocks. The experts run on
    their ranks (a reduce-scatter of the dispatch buffer along E, an
    all-gather of their rows)."""
    res = results(bundle[1][n], "moe")
    case = bundle[0]["moe"][shape]
    jc, _, _ = block_of("dbrx-132b", "attn_moe")
    out, aux = jlayers.moe_apply(jc, to_jax(case["block"]["moe"]),
                                 jnp.asarray(case["x"].numpy()))
    np.testing.assert_allclose(joined(res, shape, 0), np.asarray(out),
                               **F32)
    for r in res:
        np.testing.assert_allclose(r[shape][1], float(aux["lb_loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(r[shape][2], float(aux["z_loss"]),
                                   rtol=1e-5)
        assert r[shape][3]["reduce-scatter:model"] == 1
        assert r[shape][4] == ["experts"]
