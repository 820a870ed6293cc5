"""The port's decode policies (``repro_torch.runtime.sampling``) against the
JAX package's: Threefry keys and bits equal ``jax.random``'s bit for bit,
Gumbel noise within 1e-6, ``scale_mask`` and ``sample_rows`` on the same
numpy-seeded logits, a chi-square check of the sampled marginals, and the
port's engine's sampled streams against the JAX gather engine's (qwen2.5-3b
SMOKE, fp32): mixed policies, speculative verification, and the replay of
a stream after preemption. Tolerances: integer results exact; fp32 masks
and scaled logits 1e-6 relative (the same float32 operations); Gumbel noise
1e-6 absolute (two libraries' ``log``, one ulp at most near 16)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import sampling as jsamp  # noqa: E402
from repro.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.runtime.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.runtime import sampling as tsamp  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa


@pytest.fixture
def partitionable():
    """jax's Threefry layout the port implements: partitionable on (the
    default from jax 0.5; CI's older pin defaults to off), restored
    after."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


TRIPLES = [(0, 0, 0), (7, 3, 11), (123456, 99, 1000), (2**31 - 1, 2**20, 5)]


def _jkey(seed, rid, idx, draw=None):
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), rid),
                           idx)
    return k if draw is None else jax.random.fold_in(k, draw)


def _t(*xs):
    return [torch.tensor([x], dtype=torch.int64) for x in xs]


@pytest.mark.parametrize("draw", [None, tsamp.ACCEPT_DRAW, tsamp.SAMPLE_DRAW])
@pytest.mark.parametrize("triple", TRIPLES)
def test_keys_and_bits_equal_jax_random(partitionable, triple, draw):
    """Row keys (``ref.row_keys``, ``fold_keys`` + ``draw_keys``) and 256
    random bits of a key equal jax.random's bit for bit."""
    seed, rid, idx = triple
    jk = _jkey(seed, rid, idx, draw)
    want = np.asarray(jax.random.key_data(jk)).astype(np.int64)
    got = ref.row_keys(*_t(seed, rid, idx), draw)[0].numpy()
    assert got.tolist() == want.tolist()
    k = tsamp.fold_keys(*_t(seed, rid, idx))
    if draw is not None:
        k = tsamp.draw_keys(k, draw)
    assert k[0].tolist() == want.tolist()
    bits = np.asarray(jax.random.bits(jk, (256,))).astype(np.int64)
    assert ref.random_bits_ref(torch.from_numpy(want[None]),
                               256)[0].tolist() == bits.tolist()


@pytest.mark.parametrize("triple", TRIPLES)
def test_gumbel_noise_and_uniform_match_jax(partitionable, triple):
    """The noise's plain version (the sampler kernel's contract) against
    ``jax.random.gumbel`` within 1e-6, its bits bit for bit; the accept
    draw against ``jax.random.uniform`` exactly."""
    seed, rid, idx = triple
    jk = _jkey(seed, rid, idx, tsamp.SAMPLE_DRAW)
    want = np.asarray(jax.random.gumbel(jk, (1000,), jnp.float32))
    got = ops.sampler_noise(*_t(seed, rid, idx), 1000,
                            draw=tsamp.SAMPLE_DRAW).numpy()[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    bits = ops.sampler_noise(*_t(seed, rid, idx), 1000,
                             draw=tsamp.SAMPLE_DRAW, bits=True).numpy()[0]
    assert bits.tolist() == np.asarray(jax.random.bits(
        jk, (1000,))).astype(np.int64).tolist()
    ka = ref.row_keys(*_t(seed, rid, idx), tsamp.ACCEPT_DRAW)
    assert tsamp.uniform(ka).item() == float(jax.random.uniform(
        _jkey(seed, rid, idx, tsamp.ACCEPT_DRAW)))


POLICIES = [None, (0.8, 0, 1.0, None), (1.0, 5, 1.0, 7),
            (0.7, 0, 0.9, None), (1.3, 50, 0.5, 9), (0.0, 3, 0.4, None),
            (2.0, 1, 1.0, None)]


def _policy_pair(n):
    pols = POLICIES[:n]
    j = [None if p is None else jsamp.SamplingParams(*p) for p in pols]
    t = [None if p is None else tsamp.SamplingParams(*p) for p in pols]
    rids = list(range(3, 3 + n))
    idxs = [0, 1, 2, 5, 9, 100, 7][:n]
    return (jsamp.policy_operands(j, rids, idxs, 17),
            tsamp.policy_operands(t, rids, idxs, 17))


def test_scale_mask_matches_jax():
    """Top-k, top-p and greedy rows: the same survivors and the same
    scaled values as the JAX ``scale_mask`` (the port sorts once where
    the reference sorts twice)."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((len(POLICIES), 500))).astype(
        np.float32)
    jp, tp = _policy_pair(len(POLICIES))
    want = np.asarray(jsamp.scale_mask(jnp.asarray(logits), jp["temp"],
                                       jp["top_k"], jp["top_p"]))
    got = tsamp.scale_mask(torch.from_numpy(logits), tp.temp, tp.top_k,
                           tp.top_p).numpy()
    kept = want > tsamp.NEG_FILTER / 2
    assert ((got > tsamp.NEG_FILTER / 2) == kept).all()
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=0)
    assert kept.sum(1).min() >= 1 and (kept.sum(1) < 500).any()


@pytest.mark.parametrize("offset", [0, 3])
def test_sample_rows_equal_jax(partitionable, offset):
    """Tokens of seeded logits under mixed policies (greedy, temperature,
    top-k, top-p), at a generated-token offset: the JAX sampler's, token
    for token."""
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((len(POLICIES), 700))).astype(
        np.float32)
    jp, tp = _policy_pair(len(POLICIES))
    want = np.asarray(jsamp.sample_rows(jnp.asarray(logits), jp, offset))
    got = tsamp.sample_rows(torch.from_numpy(logits), tp, offset).numpy()
    assert got.tolist() == want.tolist()
    assert got[0] == logits[0].argmax()          # a greedy row


@pytest.mark.parametrize("bad,field", [
    (dict(temperature=-0.1), "temperature"), (dict(top_k=-1), "top_k"),
    (dict(top_p=0.0), "top_p"), (dict(top_p=1.2), "top_p"),
    (dict(temperature=float("nan")), "temperature")])
def test_params_validate_bounds(bad, field):
    tsamp.SamplingParams(temperature=1.5, top_k=3, top_p=0.5,
                         seed=7).validate()
    with pytest.raises(ValueError, match=field):
        tsamp.SamplingParams(**bad).validate()
    assert tsamp.GREEDY.is_greedy
    assert tsamp.summarize([tsamp.GREEDY, None,
                            tsamp.SamplingParams(temperature=1.0)]) \
        == "1 greedy / 1 sampled"


@pytest.mark.parametrize("top_k", [0, 3])
def test_sampled_marginals_match_softmax(top_k):
    """4000 independent draws (distinct idx) land within 4 sigma of
    softmax(logits) per bin (of the top-k survivors, renormalized; the
    rest never drawn): tests/test_sampling.py's check, on the port."""
    V, N = 8, 4000
    row = np.asarray([0.0, 1.0, 2.0, -1.0, 0.5, 1.5, -2.0, 0.25],
                     np.float32)
    keep = np.argsort(row)[::-1][:top_k] if top_k else np.arange(V)
    p_ref = np.zeros(V)
    p_ref[keep] = np.exp(row[keep]) / np.exp(row[keep]).sum()
    pol = tsamp.policy_operands(
        [tsamp.SamplingParams(temperature=1.0, top_k=top_k, seed=11)] * N,
        [0] * N, list(range(N)), 0)
    toks = tsamp.sample_rows(torch.from_numpy(row).expand(N, V), pol)
    counts = np.bincount(toks.numpy(), minlength=V)
    for v in range(V):
        sd = np.sqrt(N * p_ref[v] * (1 - p_ref[v]))
        assert abs(counts[v] - N * p_ref[v]) <= 4 * sd + 1, (v, counts)


# ---------------------------------------------------------------------------
# The engine against the JAX gather engine (fp32 so the tokens are exact)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jcfg("qwen2.5-3b"), dtype="float32")
    tc = dataclasses.replace(tcfg("qwen2.5-3b"), dtype="float32")
    jp = japi.init_params(jc, jax.random.key(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


MIXED = [None, (0.9, 0, 0.95, None), (1.0, 5, 1.0, 7), None,
         (0.8, 12, 0.9, 31)]


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(1, 200, int(n))]
            for n in rng.integers(4, 14, len(MIXED))]


def _serve(engine_cls, req_cls, sp_cls, cfg, params, prompts, policies,
           rids=None, **kw):
    kw = dict(dict(slots=2, max_len=64, page_size=4), **kw)
    eng = engine_cls(cfg, params, **kw)
    rids = list(range(len(prompts))) if rids is None else rids
    reqs = [req_cls(rid=rid, prompt=p, max_new=10,
                    params=None if pol is None else sp_cls(*pol))
            for rid, p, pol in zip(rids, prompts, policies)]
    sched = (Scheduler if engine_cls is PagedServingEngine
             else JScheduler)(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=500)
    return [r.generated for r in reqs], eng, sched


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_sampled_streams_equal_jax_gather_engine(partitionable, pair,
                                                        spec_k):
    """Mixed greedy / sampled requests on 2 slots (continuous batching),
    plain and speculative (rejection-sampled verification): the port's
    engine emits the JAX gather engine's tokens, and one policy mix needs
    no second graph (no capture on the CPU at all)."""
    jc, tc, jp, tp = pair
    want, _, _ = _serve(JEngine, JRequest, jsamp.SamplingParams, jc, jp,
                        _prompts(), MIXED, attn_impl="gather",
                        spec_k=spec_k)
    got, eng, _ = _serve(PagedServingEngine, Request, tsamp.SamplingParams,
                         tc, tp, _prompts(), MIXED, device="cpu",
                         spec_k=spec_k)
    assert got == want
    s = eng.sampling_stats()
    assert s["sampled_requests"] == 3 and s["greedy_requests"] == 2
    assert s["sampled_tokens"] == 30 and s["greedy_tokens"] == 20
    assert s["step_traces"] == s["spec_traces"] == 0
    assert eng.alloc.allocated_pages == 0


def test_sampled_stream_replays_after_preemption(partitionable, pair):
    """A sampled request's stream is the same alone, in a batch, and after
    a preemption (a pool one page past the largest request's need, short
    of both: decode growth preempts the youngest, which resumes by
    re-prefill, drawing with the same (seed, rid, index) keys)."""
    _, tc, _, tp = pair
    prompts, pols = _prompts()[:2], [MIXED[4], MIXED[1]]
    alone = [_serve(PagedServingEngine, Request, tsamp.SamplingParams, tc,
                    tp, [p], [pol], [i], device="cpu")[0][0]
             for i, (p, pol) in enumerate(zip(prompts, pols))]
    batch, _, _ = _serve(PagedServingEngine, Request, tsamp.SamplingParams,
                         tc, tp, prompts, pols, device="cpu")
    pre, eng, sched = _serve(PagedServingEngine, Request,
                             tsamp.SamplingParams, tc, tp, prompts, pols,
                             device="cpu", num_pages=1 + max(
                                 -(-(len(p) + 10) // 4) for p in prompts))
    assert sched.preempted >= 1
    assert alone == batch == pre
    assert len({tuple(t) for t in alone}) == 2
    eng.alloc.check_no_aliasing()


def test_scheduler_validates_params_at_enqueue(pair):
    _, tc, _, tp = pair
    eng = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                             device="cpu")
    sched = Scheduler(eng)
    bad = Request(rid=0, prompt=[1, 2, 3], max_new=2,
                  params=tsamp.SamplingParams(top_p=0.0))
    with pytest.raises(ValueError, match="top_p"):
        sched.add(bad)
    assert not sched.pending
    with pytest.raises(ValueError, match="temperature"):
        PagedServingEngine(tc, tp, temperature=-1.0, device="cpu")


def test_engine_default_policy_and_seed(partitionable, pair):
    """``sampling=`` is the default of requests without their own policy,
    ``temperature=`` builds one, and ``seed=`` seeds policies without a
    seed: the JAX engine's resolution, token for token."""
    jc, tc, jp, tp = pair
    prompts = _prompts()[:3]
    for kw in (dict(temperature=0.7, seed=5),
               dict(sampling=(0.9, 4, 1.0, None), seed=9)):
        jkw, tkw = dict(kw), dict(kw)
        if "sampling" in kw:
            jkw["sampling"] = jsamp.SamplingParams(*kw["sampling"])
            tkw["sampling"] = tsamp.SamplingParams(*kw["sampling"])
        want, _, _ = _serve(JEngine, JRequest, jsamp.SamplingParams, jc, jp,
                            prompts, [None] * 3, attn_impl="gather", **jkw)
        got, eng, _ = _serve(PagedServingEngine, Request,
                             tsamp.SamplingParams, tc, tp, prompts,
                             [None] * 3, device="cpu", **tkw)
        assert got == want
        assert eng.sampling_stats()["sampled_requests"] == 3
