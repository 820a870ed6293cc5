"""The port's dense-slot engine and engine factory against the JAX
package's (``repro.runtime.serving.DenseServingEngine`` and
``ServingEngine``), on the CPU at SMOKE sizes.

Weights are the JAX package's init, moved over by
``repro_torch.convert.params_from_jax``; prompts are numpy from a seed.
fp32 weights, activations and KV cache: greedy tokens are compared
exactly (the same fp32 arithmetic, sums in another order, no near tie on
these prompts). Sampled streams are compared exactly too: the port's
Threefry keys and bits equal jax's (partitionable layout, pinned in a
fixture as ``tests/test_torch_sampling.py`` pins it).
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402

from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import sampling as jsamp  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.runtime import sampling as tsamp  # noqa: E402
from repro_torch.runtime.drafter import NgramDrafter  # noqa: E402
from repro_torch.runtime.scheduler import (Scheduler,  # noqa: E402
                                           SchedulerExhausted)
from repro_torch.runtime.serving import (DenseServingEngine,  # noqa: E402
                                         PagedServingEngine, Request,
                                         ServingEngine)
from repro_torch.runtime.trace import Tracer, validate_trace  # noqa: E402
from torch_cases import dying_traffic  # noqa: E402

QWEN, RG, MAMBA, DBRX = ("qwen2.5-3b", "recurrentgemma-9b", "mamba2-2.7b",
                         "dbrx-132b")
SEAMLESS = "seamless-m4t-large-v2"


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax cfg, port cfg, jax params, port params), fp32 with an fp32 KV
    cache, made once per module."""
    over = dict(dtype="float32", kv_cache_dtype="float32")
    jc = dataclasses.replace(jcfg(arch), **over)
    tc = dataclasses.replace(tcfg(arch), **over)
    jp = japi.init_params(jc, jax.random.key(0))
    return jc, tc, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture
def partitionable():
    """jax's Threefry layout the port implements, restored after."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def drive(eng, traffic, *, req_cls=Request, sched_cls=Scheduler,
          max_steps=500):
    """Serve ``traffic`` [(prompt, max_new, params)] through a scheduler;
    returns the requests."""
    reqs = [req_cls(rid=i, prompt=list(p), max_new=n, params=pol)
            for i, (p, n, pol) in enumerate(traffic)]
    sched = sched_cls(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=max_steps)
    return reqs


def jax_dense(arch, traffic, **kw):
    jc, _, jp, _ = pair(arch)
    eng = jserving.DenseServingEngine(jc, jp, **kw)
    return [r.generated for r in drive(eng, traffic, req_cls=jserving.Request,
                                       sched_cls=JScheduler)]


def prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


# (prompt lengths, max_new, engine kwargs): recurrentgemma's prompts and
# generations run past its SMOKE window of 16 (the ring wraps)
CASES = {
    QWEN: ([5, 11, 3, 17], 7, dict(slots=2, max_len=32)),
    RG: ([28, 6, 24], 14, dict(slots=2, max_len=64)),
    MAMBA: ([9, 4, 13], 8, dict(slots=2, max_len=32)),
}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_dense_tokens_equal_jax_dense_and_paged(arch):
    """Greedy tokens of the port's dense engine equal the JAX dense
    engine's and the port's paged kernel engine's, with more requests than
    slots (slots are reused)."""
    lengths, max_new, kw = CASES[arch]
    _, tc, _, tp = pair(arch)
    traffic = [(p, max_new, None)
               for p in prompts(len(lengths), lengths, tc.vocab)]
    got = [r.generated for r in drive(
        DenseServingEngine(tc, tp, device="cpu", **kw), traffic)]
    assert got == jax_dense(arch, traffic, **kw)
    assert all(len(g) == max_new for g in got)
    paged = [r.generated for r in drive(
        PagedServingEngine(tc, tp, page_size=4, device="cpu", **kw),
        traffic)]
    assert got == paged


@pytest.mark.parametrize("slots", [6, 8])
def test_dbrx_dying_slots_tokens_equal_jax_dense(slots):
    """dbrx SMOKE (4 experts, top-2) at 6 and 8 slots with budgets that end
    requests at different steps: every decode step routes every slot's
    row, dead rows included, through experts of capacity 4 or 6, so a dead
    row must compute what the reference's does (its current token the one
    it sampled, its position frozen, its lane as the reference left it),
    or it pushes live tokens out of capacity. The tokens equal the JAX
    dense engine's."""
    _, tc, _, tp = pair(DBRX)
    assert layers.moe_capacity(tc, slots)[1] == (4 if slots == 6 else 6)
    traffic = [(p, n, None) for p, n in dying_traffic(slots, tc.vocab)]
    kw = dict(slots=slots, max_len=32)
    got = drive(DenseServingEngine(tc, tp, device="cpu", **kw), traffic)
    assert len({len(r.generated) for r in got}) > 3     # staggered deaths
    assert [r.generated for r in got] == jax_dense(DBRX, traffic, **kw)


def test_dead_slot_row_takes_its_sample_and_keeps_its_position():
    """After a request finishes, its slot's row keeps running: the current
    token becomes the row's greedy draw each step, the position stays
    where the request left it, and the policy row is greedy."""
    _, tc, _, tp = pair(QWEN)
    eng = DenseServingEngine(tc, tp, slots=2, max_len=32, device="cpu")
    assert eng.submit(Request(rid=0, prompt=[3, 4, 5], max_new=2))
    assert eng.submit(Request(rid=1, prompt=[7, 8, 9, 10], max_new=6))
    eng.step()
    assert eng.live[0] is None and eng.live[1] is not None
    frozen = int(eng.pos[0])
    assert frozen == 4
    for _ in range(3):
        eng.step()
        argmax = int(eng.last_logits[0, : tc.vocab].argmax())
        assert int(eng.cur_tok[0, 0]) == argmax
        assert int(eng.pos[0]) == frozen
    assert float(eng.pol.temp[0]) == 0.0


# ---------------------------------------------------------------------------
# The reference's dense-engine cases (tests/test_serving.py)
# ---------------------------------------------------------------------------


def test_dense_overlong_prompt_rejected_as_done():
    """A prompt at or over max_len - 1, or a request with no budget, is
    done at once with nothing generated; the healthy neighbour is served
    (``tests/test_serving.py``'s case)."""
    _, tc, _, tp = pair(QWEN)
    eng = DenseServingEngine(tc, tp, slots=2, max_len=16, device="cpu")
    bad = Request(rid=0, prompt=list(range(1, 20)), max_new=4)
    edge = Request(rid=1, prompt=list(range(1, 16)), max_new=4)
    spent = Request(rid=2, prompt=[1, 2], max_new=0)
    ok = Request(rid=3, prompt=[1, 2, 3], max_new=3)
    done = eng.run_to_completion([bad, edge, spent, ok], max_steps=40)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert bad.generated == [] and edge.generated == []
    assert spent.generated == []
    assert len(ok.generated) == 3
    assert eng.prefill_traces == 1


def test_dense_run_to_completion_raises_on_exhausted_budget():
    _, tc, _, tp = pair(QWEN)
    eng = DenseServingEngine(tc, tp, slots=1, max_len=32, device="cpu")
    with pytest.raises(SchedulerExhausted):
        eng.run_to_completion([Request(rid=0, prompt=[1, 2, 3], max_new=8)],
                              max_steps=2)


@pytest.mark.parametrize("engine", ["factory", "dense"])
def test_engine_batched_isolation(engine):
    """A request's tokens do not depend on what shares the batch (through
    the factory, which picks the paged engine for qwen, and through the
    dense engine)."""
    _, tc, _, tp = pair(QWEN)
    make = ServingEngine if engine == "factory" else DenseServingEngine
    alone = make(tc, tp, slots=1, max_len=32, device="cpu").run_to_completion(
        [Request(rid=0, prompt=[3, 1, 4], max_new=4)],
        max_steps=10)[0].generated
    done = make(tc, tp, slots=2, max_len=32, device="cpu").run_to_completion(
        [Request(rid=0, prompt=[3, 1, 4], max_new=4),
         Request(rid=1, prompt=[2, 7, 1, 8, 2], max_new=4)], max_steps=10)
    assert [r for r in done if r.rid == 0][0].generated == alone


MIXED = [None, (0.9, 0, 0.95, None), (1.0, 5, 1.0, 7), None,
         (0.8, 12, 0.9, 31)]


def test_dense_sampled_streams_equal_jax_dense(partitionable):
    """Mixed greedy and sampled requests (temperature, top-k, top-p, own
    seeds) on 2 slots: the port's dense engine emits the JAX dense
    engine's tokens."""
    _, tc, _, tp = pair(QWEN)
    ps = prompts(3, [6, 9, 4, 12, 7], tc.vocab)

    def traffic(sp_cls):
        return [(p, 9, None if pol is None else sp_cls(*pol))
                for p, pol in zip(ps, MIXED)]
    eng = DenseServingEngine(tc, tp, slots=2, max_len=32, seed=5,
                             device="cpu")
    got = [r.generated for r in drive(eng, traffic(tsamp.SamplingParams))]
    assert got == jax_dense(QWEN, traffic(jsamp.SamplingParams), slots=2,
                            max_len=32, seed=5)
    assert eng.sampled_tokens > 0 and eng.greedy_tokens > 0


# ---------------------------------------------------------------------------
# metrics and trace (tests/test_metrics.py's dense half)
# ---------------------------------------------------------------------------

SUBSYSTEMS = ("pool_stats", "spec_stats", "prefix_stats", "tier_stats",
              "shard_stats", "sampling_stats")


@pytest.fixture(scope="module")
def driven():
    """The port's dense and paged engines and the JAX dense engine, each
    after the same 3 requests."""
    jc, tc, jp, tp = pair(QWEN)
    traffic = [(p, 3, None) for p in prompts(9, [2, 4, 6], tc.vocab)]
    mk = dict(slots=2, max_len=32)
    out = {}
    for name, eng in (
            ("dense", DenseServingEngine(tc, tp, device="cpu", **mk)),
            ("paged", PagedServingEngine(tc, tp, device="cpu", **mk))):
        drive(eng, traffic)
        out[name] = eng
    jeng = jserving.DenseServingEngine(jc, jp, **mk)
    drive(jeng, traffic, req_cls=jserving.Request, sched_cls=JScheduler)
    out["jax"] = jeng
    return out


def test_dense_metrics_key_set_equals_paged_and_jax(driven):
    """The dense engine's flat ``metrics()`` keys equal the port's paged
    engine's and the JAX dense engine's; each ``*_stats()`` key set too."""
    keys = {name: set(e.metrics()) for name, e in driven.items()}
    assert keys["dense"] == keys["paged"] == keys["jax"]
    for meth in SUBSYSTEMS:
        got = getattr(driven["dense"], meth)()
        got = dataclasses.asdict(got) if meth == "pool_stats" else got
        want = getattr(driven["jax"], meth)()
        want = dataclasses.asdict(want) if meth == "pool_stats" else want
        assert set(got) == set(want), meth


def test_dense_counters_equal_jax_dense(driven):
    """The same traffic gives the JAX dense engine's counters, but the one
    that differs by design (the reference counts its step's jit traces,
    the port its graph's captures: none on the CPU)."""
    got, want = driven["dense"].metrics(), driven["jax"].metrics()
    for k in ("engine.decode_steps", "engine.decoded_tokens",
              "engine.prefill_traces", "latency.requests",
              "pool.dense_equiv_tokens", "prefix.prompt_tokens",
              "prefix.prefilled_tokens", "sampling.greedy_tokens",
              "sampling.greedy_requests", "shard.pool_bytes_per_shard"):
        assert got[k] == want[k], k
    assert got["engine.kind"] == "DenseServingEngine"
    assert got["sampling.step_traces"] == 0.0


def test_dense_engine_run_produces_valid_trace():
    """A traced dense run: the spans and instants the reference's trace
    case requires, one async begin/end pair a request, and it validates."""
    _, tc, _, tp = pair(QWEN)
    tr = Tracer(enabled=True)
    eng = DenseServingEngine(tc, tp, slots=2, max_len=32, tracer=tr,
                             device="cpu")
    reqs = drive(eng, [(p, 3, None)
                       for p in prompts(9, [2, 4, 6], tc.vocab)])
    obj = tr.to_dict()
    assert validate_trace(obj) == []
    evs = obj["traceEvents"]
    spans = {e["name"] for e in evs if e.get("ph") == "X"}
    assert {"admit", "prefill_dispatch", "decode_tick", "device_dispatch",
            "host_sync", "tick", "admit_loop"} <= spans
    assert "first_token" in {e["name"] for e in evs if e.get("ph") == "i"}
    begins = [e["id"] for e in evs if e.get("ph") == "b"]
    ends = [e["id"] for e in evs if e.get("ph") == "e"]
    assert sorted(begins) == sorted(ends) == [str(r.rid) for r in reqs]


# ---------------------------------------------------------------------------
# the factory (tests/test_hybrid_paging.py, tests/test_sampling.py)
# ---------------------------------------------------------------------------


def test_factory_dense_fallback_warns_naming_dropped_kwargs():
    """seamless (encoder-decoder) falls back to the dense engine; the paged
    kwargs set away from their defaults are named in one warning."""
    _, tc, _, tp = pair(SEAMLESS)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = ServingEngine(tc, tp, slots=2, max_len=32, prefix_cache=True,
                            attn_impl="gather", page_size=8, device="cpu")
    assert isinstance(eng, DenseServingEngine)
    msgs = [str(x.message) for x in w]
    assert any("prefix_cache" in m and "attn_impl" in m and "page_size" in m
               for m in msgs), msgs


def test_factory_dense_fallback_raises_on_spec_k():
    """A truthy spec_k raises; kwargs at their paged defaults drop
    quietly."""
    _, tc, _, tp = pair(SEAMLESS)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tc, tp, slots=2, max_len=32, spec_k=4, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = ServingEngine(tc, tp, slots=2, max_len=32, spec_k=0,
                            page_size=16, prefix_cache=False, device="cpu")
    assert isinstance(eng, DenseServingEngine)
    assert not w, [str(x.message) for x in w]


def test_factory_dense_fallback_raises_on_drafter():
    _, tc, _, tp = pair(SEAMLESS)
    with pytest.raises(ValueError, match="verify step"):
        ServingEngine(tc, tp, slots=2, max_len=32, drafter=NgramDrafter(),
                      device="cpu")


@pytest.mark.parametrize("arch", [QWEN, RG, MAMBA, DBRX])
def test_factory_picks_the_paged_engine_where_it_can(arch):
    _, tc, _, tp = pair(arch)
    eng = ServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                        device="cpu")
    assert type(eng) is PagedServingEngine
    assert type(jserving.ServingEngine(*pair(arch)[::2], slots=2,
                                       max_len=32)) \
        is jserving.PagedServingEngine
