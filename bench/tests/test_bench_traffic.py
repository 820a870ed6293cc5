import numpy as np
import pytest

from bench.lib import spec, traffic as tr


@pytest.mark.parametrize("mix", ["reason", "chat", "rag", "rag4k"])
def test_deck_is_deterministic_and_in_range(mix):
    m = spec.traffic(mix)
    a, b = tr.Deck(m, 2**31 + 7), tr.Deck(m, 2**31 + 7)
    ca = a.first() + [a.next() for _ in range(200)]
    cb = b.first() + [b.next() for _ in range(200)]
    assert ca == cb
    other = tr.Deck(m, 3)
    assert other.first() + [other.next() for _ in range(200)] != ca
    for c in ca[m["clients"]:]:
        assert m["prompt"]["min"] <= c.prompt_len <= m["prompt"]["max"]
        assert m["output"]["min"] <= c.output_len <= m["output"]["max"]
    for c in ca[:m["clients"]]:
        assert 1 <= c.output_len <= m["output"]["max"]
        assert c.prompt_len + c.output_len <= m["max_len"]
    assert len({c.rid for c in ca}) == len(ca)


def test_every_seed_serves_the_same_sizes():
    m = spec.traffic("reason")
    sizes = []
    for seed in (1, 2, 2**33):
        d = tr.Deck(m, seed)
        d.first()
        block = [d.next() for _ in range(m["block"])]
        sizes.append((sorted(c.prompt_len for c in block),
                      sorted(c.output_len for c in block),
                      sum(c.greedy for c in block)))
    assert sizes[0] == sizes[1] == sizes[2]
    assert sizes[0][2] == round(m["block"] * m["greedy_share"])


def test_residual_life_is_length_biased():
    dist = {"dist": "uniform", "min": 1024, "max": 3072}
    q = tr.grid(4096)
    r = tr.residual_quantile(dist, q)
    # mean residual of a uniform length: E[L^2] / (2 E[L])
    L = np.arange(1024, 3073)
    want = (L.astype(float) ** 2).mean() / (2 * L.mean())
    assert abs(r.mean() - want) / want < 0.01
    assert r.min() >= 1 and r.max() <= 3072


def test_loguniform_quantiles():
    dist = {"dist": "loguniform", "min": 64, "max": 512}
    v = tr.quantile(dist, tr.grid(1000))
    assert v.min() == 64 and v.max() == 512
    assert abs(np.median(v) - np.sqrt(64 * 513)) < 3


def test_buckets_follow_the_port_rule():
    assert tr.buckets(spec.traffic("reason")) == [64, 128, 256, 512]
    assert tr.buckets(spec.traffic("rag")) == [1024, 2048, 4096, 8192]
    assert tr.bucket(8192, 16, 8320) == 8192
    assert tr.bucket(5, 16, 8320) == 16

