"""The plain reference against the port's engine, on the CPU at a tiny
size, with the benchmark's own weights: the prefill's logits agree to
bf16 rounding, and the tokens the engine serves alone are the
reference's best."""
import numpy as np
import pytest
import torch

from bench.lib import model, serve
from bench.reference import model as ref
from bench.reference.dims import dims
from bench_tiny import config


@pytest.mark.parametrize("name", ["qwen2.5-3b", "dbrx-132b"])
def test_prefill_logits_agree(name):
    from repro_torch.models import api
    cfg = config(name)
    dm = dims(cfg)
    w = model.make_weights(cfg, 7, "cpu")
    L, bucket = 40, 64
    prompt = [int(x) for x in np.random.default_rng(0).integers(0, dm.vocab,
                                                                L)]
    tok = torch.zeros((1, bucket), dtype=torch.long)
    tok[0, :L] = torch.tensor(prompt)
    logits, _, _ = api.prefill(model.port_config(cfg), w, tok,
                               length=torch.tensor([L], dtype=torch.int32))
    z = ref.served_logits(dm, w, prompt, [0], bucket, 64)
    err = (logits[0, :dm.vocab] - z[0]).abs().max().item()
    assert err < 0.02 * z[0].abs().max().item()


@pytest.mark.parametrize("name", ["qwen2.5-3b", "dbrx-132b"])
def test_served_tokens_are_the_references_best(name):
    from repro_torch.runtime.serving import Request
    cfg = config(name)
    dm = dims(cfg)
    w = model.make_weights(cfg, 7, "cpu")
    mix = dict(slots=64, max_len=192, page_size=16, sampled=None)
    eng, _ = serve.make_engine(model.port_config(cfg), w, mix, 7, None,
                               "cpu")
    prompt = [int(x) for x in np.random.default_rng(3).integers(0, dm.vocab,
                                                                40)]
    req = Request(rid=5, prompt=prompt, max_new=24)
    assert eng.submit(req)
    while eng.has_live():
        eng.step()
    z = ref.served_logits(dm, w, prompt, list(req.generated), 64, 64)
    idx = torch.tensor(req.generated)
    gap = z.max(-1).values - z[torch.arange(len(idx)), idx]
    assert len(req.generated) == 24
    assert gap.max().item() < 0.05


def test_capacity_rule_drops_slot_major():
    cfg = config("dbrx-132b")
    dm = dims(cfg)
    # 64 identical rows in groups of 2: every expert sees 2 a group, C = 4
    router = torch.randn(dm.d, dm.experts)
    h = torch.randn(1, dm.d).expand(64, dm.d)
    _, _, keep = ref.route(dm, router, h, groups=True)
    assert keep.all()
    # 512 identical rows: 32 groups of 16, C = max(4, 16 * 1.25 * 4 // 16)
    # = 5: in each group the first 5 rows keep their choices, the rest
    # are dropped
    h = torch.randn(1, dm.d).expand(512, dm.d)
    _, _, keep = ref.route(dm, router, h, groups=True)
    grp = keep.view(32, 16, dm.top_k)
    assert grp[:, :5].all() and not grp[:, 5:].any()
    assert ref.decode_never_drops(dm, 64)
    assert not ref.decode_never_drops(dm, 16)


def test_weights_layout_is_the_ports():
    from repro_torch.models import api
    for name in ("qwen2.5-3b", "dbrx-132b"):
        cfg = config(name)
        shapes = api.param_shapes(model.port_config(cfg))
        got = model.make_weights(cfg, 1, "cpu")
        ref_tree = api.init_params(model.port_config(cfg),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")

        def cmp(a, b, c):
            if isinstance(a, dict):
                assert set(a) == set(b) == set(c)
                for k in a:
                    cmp(a[k], b[k], c[k])
            elif isinstance(a, list):
                assert len(a) == len(b) == len(c)
                for x, y, z in zip(a, b, c):
                    cmp(x, y, z)
            else:
                assert tuple(a) == tuple(b.shape)
                assert b.dtype == c.dtype
        cmp(shapes, got, ref_tree)


def test_weights_are_the_seeds():
    cfg = config("qwen2.5-3b")
    a = model.make_weights(cfg, 2**31 + 5, "cpu")
    b = model.make_weights(cfg, 2**31 + 5, "cpu")
    c = model.make_weights(cfg, 9, "cpu")
    wa, wb, wc = (t["blocks"][1]["mlp"]["wi"] for t in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)


def test_the_references_noise_is_the_samplers():
    from repro_torch.kernels import ref as port_ref
    from bench.reference import sampling as rs
    idx = torch.arange(5, 12)
    for seed, rid in ((0, 0), (2**31 - 1, 7), (123456789, 2**20 + 3)):
        mine = rs.gumbel(rs.keys(seed, rid, idx), 1000)
        n = len(idx)
        theirs = port_ref.sampler_noise_ref(
            torch.full((n,), seed), torch.full((n,), rid), idx, 1000,
            draw=rs.SAMPLE_DRAW)
        assert torch.equal(mine, theirs)


def test_a_sampled_request_alone_is_the_references_draw():
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.serving import Request
    from bench.reference import sampling as rs
    cfg = config("qwen2.5-3b")
    dm = dims(cfg)
    w = model.make_weights(cfg, 7, "cpu")
    mix = dict(slots=8, max_len=192, page_size=16, sampled=None)
    eng, _ = serve.make_engine(model.port_config(cfg), w, mix, 7, None,
                               "cpu")
    prompt = [int(x) for x in np.random.default_rng(4).integers(0, dm.vocab,
                                                                30)]
    req = Request(rid=9, prompt=prompt, max_new=40,
                  params=SamplingParams(temperature=0.7, top_p=0.95,
                                        seed=1234))
    assert eng.submit(req)
    while eng.has_live():
        eng.step()
    z = ref.served_logits(dm, w, prompt, list(req.generated), 32, 8)
    drawn = rs.draw(z, 1234, 9, 0.7, 0.95)
    assert drawn.tolist() == list(req.generated)
    g = rs.gaps(z, torch.tensor(req.generated), 1234, 9, 0.7, 0.95, 0.005)
    assert g.max().item() == 0.0
    # drawn at temperature 1 the tokens leave the rule
    wrong = rs.draw(z, 1234, 9, 1.0, 1.0)
    assert rs.gaps(z, wrong, 1234, 9, 0.7, 0.95, 0.005).max().item() > 0.05
