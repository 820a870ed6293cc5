"""The correctness sample: the longest finished request of its kind whole,
then others in an order drawn from the seed; with ``check_requests`` one
a client, and with ``check_slice`` each judged over its first tokens."""
from bench.lib import correct
from bench.lib.stats import Record


def recs(n=40, clients=8):
    out = []
    for i in range(n):
        k = 10 + (i * 7) % 23
        out.append(Record(rid=i, client=i % clients, sent=0.0, prompt_len=8,
                          max_new=k, greedy=i % 4 != 0, stamps=[0.0] * k,
                          tokens=[1] * k, done=True))
    return out


def test_the_longest_comes_whole_then_the_seeds_order():
    rs = recs()
    a = correct.sample(rs, 5, True, 100)
    assert a[0][0].max_new == max(r.max_new for r in rs if r.greedy)
    assert all(k == len(r.tokens) and r.greedy for r, k in a)
    assert sum(k for _, k in a[:-1]) < 100 <= sum(k for _, k in a)
    assert a == correct.sample(rs, 5, True, 100)
    assert a != correct.sample(rs, 6, True, 100)


def test_slices_span_the_clients():
    rs = recs()
    a = correct.sample(rs, 5, True, 10_000, requests=6, cut=4)
    assert len(a) == 6
    assert len({r.client for r, _ in a}) == 6
    assert a[0][1] == len(a[0][0].tokens)
    assert all(k == 4 for _, k in a[1:])


def test_the_kinds_are_apart():
    rs = recs()
    s = correct.sample(rs, 5, False, 10_000)
    assert s and all(not r.greedy for r, _ in s)
    unfinished = [Record(rid=0, client=0, sent=0.0, prompt_len=8, max_new=9,
                         greedy=True, stamps=[0.0], tokens=[1])]
    assert correct.sample(unfinished, 5, True, 100) == []
