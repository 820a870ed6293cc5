"""Context-parallel prefill and dense-lane decode held to the JAX
package's, on the CPU over gloo: the sequence split over ``model``, in
spawned worlds of 2 and 4 gloo ranks (the ranks are
``tests/torch_cp_ranks.py``, which imports no jax), whole weights on every
rank. Each rank prefills its block of the prompts into its block of the
dense lanes (``max_len``) and runs 8 greedy decode steps on those blocks
(qwen2.5-3b, and recurrentgemma-9b, whose window ring wraps, with an fp32
cache), against JAX ``api.prefill(max_len=)`` and ``api.decode_step`` on
the whole prompts: the last-position logits and every step's logits
within atol = rtol = 2e-5 on every rank, the greedy tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from torch_cp_cases import (F32, SERVE_ARCHS, SERVE_MAX,  # noqa: E402
                            SERVE_STEPS, WORLDS, bundle_and_worlds)
from torch_train_cases import one_thread, pair, results  # noqa: E402,F401


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(inputs, worlds): what the ranks read, their results."""
    return bundle_and_worlds(tmp_path_factory.mktemp("cp_serve"),
                             ("serve",))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_dense_decode_equal_jax(bundle, n, arch):
    """The ranks' prefill (each its block of the prompt, the logits at the
    last position from the rank that holds it) and greedy decode on their
    blocks of the lanes (the owner writes each new row; recurrentgemma's
    window ring of 16 wraps during the prompt and the rglru state runs
    whole) give JAX's logits and tokens on every rank."""
    res = results(bundle[1][n], "serve")
    case = bundle[0]["serve"][arch]
    jc, _, jp, _ = pair(arch, kv_cache_dtype="float32")
    logits, cache, pos = japi.prefill(
        jc, jp, {"tokens": jnp.asarray(case["tokens"].numpy())},
        max_len=SERVE_MAX)
    first, steps, toks = np.asarray(logits), [], []
    for _ in range(SERVE_STEPS):
        tok = jnp.argmax(logits, -1)
        toks.append(np.asarray(tok))
        logits, cache = japi.decode_step(jc, jp, cache, tok[:, None], pos)
        steps.append(np.asarray(logits))
        pos = pos + 1
    for r in res:
        got_first, got_steps, got_toks = r[arch]
        np.testing.assert_allclose(got_first, first, **F32)
        np.testing.assert_array_equal(got_toks, np.stack(toks))
        np.testing.assert_allclose(got_steps, np.stack(steps), **F32)
