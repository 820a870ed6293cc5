"""Context parallelism's attention held to the JAX package's, on the CPU
over gloo: the sequence split over ``model`` (the reference's
``Rules(mesh, {"seq": "model"})``), each rank on its block of every row.

* ``layers.flash_attention(q_offset=)`` (the training attention at a
  rank's query offset), chunked and one-shot, causal and window, against
  the jnp ``layers.flash_attention(q_offset=)``, no world needed;
* in spawned worlds of 2 and 4 gloo ranks (``launch.mesh.run_world``;
  the ranks are ``tests/torch_cp_ranks.py``, which imports no jax), each
  rank's rows joined and held to the JAX function on the whole sequence:
  ``attention_apply`` (training and prefill, full and windowed: the keys
  gathered, the queries at the rank's offset) and ``attention_decode``
  on the ranks' blocks of dense lanes (``decode_kv_chunk`` 0, 2048 and
  4, a full lane and a window ring across its wrap: the owner's write
  and the merged partial softmaxes).

The mixers and the MoE are in ``tests/test_torch_cp_moe.py``, the model's
prefill and dense decode in ``tests/test_torch_cp_serve.py``; the cases
and tolerances in ``tests/torch_cp_cases.py`` (atol = rtol = 2e-5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from torch_cp_cases import (ATTN_CASES, DECODE_CASES, F32,  # noqa: E402
                            WORLDS, block_of, bundle_and_worlds, joined,
                            to_jax)
from torch_train_cases import one_thread, results  # noqa: E402,F401


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(inputs, worlds): what the ranks read, their results."""
    return bundle_and_worlds(tmp_path_factory.mktemp("cp_layers"),
                             ("attention", "decode"))


# ---------------------------------------------------------------------------
# flash_attention at a query offset
# ---------------------------------------------------------------------------

FLASH_OFFSET = {   # name: (Sq, Sk, q_offset, kwargs)
    "chunked": (24, 64, 40, {"q_chunk": 8, "kv_chunk": 16}),
    "chunked_window": (24, 64, 40, {"q_chunk": 8, "kv_chunk": 16,
                                    "window": 11}),
    "one_shot": (16, 64, 16, {"chunked": False}),
    "one_shot_window": (16, 64, 32, {"chunked": False, "window": 9}),
    "first_block": (16, 64, 0, {"q_chunk": 8, "kv_chunk": 16}),
}


@pytest.mark.parametrize("name", list(FLASH_OFFSET))
def test_flash_attention_at_a_query_offset_equals_jax(name):
    """A context-parallel rank's queries (Sq rows at ``q_offset``)
    against the whole sequence's keys, causal by absolute position, and
    the gradient."""
    Sq, Sk, off, kw = FLASH_OFFSET[name]
    rng = np.random.default_rng(len(name))
    q, k, v, cot = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, Sq, 4, 16), (2, Sk, 2, 16), (2, Sk, 2, 16), (2, Sq, 4, 16)))
    want, jg = jax.value_and_grad(
        lambda q, k, v: jnp.sum(jlayers.flash_attention(
            q, k, v, q_offset=off, **kw) * cot), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    jout = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_offset=off, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.flash_attention(tq, tk, tv, q_offset=off, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **F32)
    (out * torch.from_numpy(cot)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-7)
    # the offset counts: at offset 0 the same rows see other keys
    if off:
        moved = layers.flash_attention(tq, tk, tv, **kw).detach().numpy()
        assert np.abs(moved - np.asarray(jout)).max() > 1e-3


# ---------------------------------------------------------------------------
# the layers over worlds of 2 and 4 ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_apply_blocks_equal_jax(bundle, n, case):
    res = results(bundle[1][n], "attention")
    window, chunked, _ = ATTN_CASES[case]
    a = bundle[0]["attn"]
    jc, _, _ = block_of("qwen2.5-3b", "attn_mlp", kv_cache_dtype="float32")
    jc = dataclasses.replace(jc, flash_chunking=chunked)
    out, (k, v) = jlayers.attention_apply(jc, to_jax(a["p"]),
                                          jnp.asarray(a["x"].numpy()),
                                          window=window)
    for i, want in enumerate((out, k, v)):
        np.testing.assert_allclose(joined(res, case, i), np.asarray(want),
                                   **F32)
    assert res[0]["collectives"]["all-gather:model"] > 0
    assert all(w["jax_loaded"] == [] for w in bundle[1][n])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_attention_decode_lanes_equal_jax(bundle, n, case):
    """The output on every rank equals JAX's, and the ranks' lane blocks
    joined equal JAX's new lane: the one new row written by its owner
    (the ring's slot pos % 8 after its wrap), every other row as it
    was."""
    res = results(bundle[1][n], "decode")
    window, chunk = DECODE_CASES[case]
    dc = bundle[0]["decode"]
    jc, _, _ = block_of("qwen2.5-3b", "attn_mlp", kv_cache_dtype="float32")
    jc = dataclasses.replace(jc, decode_kv_chunk=chunk)
    lanes = {k: jnp.asarray(t.numpy()) for k, t in
             dc["lanes"][window].items()}
    out, cache = jlayers.attention_decode(
        jc, to_jax(dc["p"]), jnp.asarray(dc["x"].numpy()), lanes,
        jnp.asarray(dc["pos"][window].numpy()), window=window)
    for r in res:
        np.testing.assert_allclose(r[case][0], np.asarray(out), **F32)
    for i, name in ((1, "k"), (2, "v")):
        np.testing.assert_allclose(joined(res, case, i),
                                   np.asarray(cache[name]), **F32)
    assert res[0]["collectives"]["all-reduce:model"] > 0
