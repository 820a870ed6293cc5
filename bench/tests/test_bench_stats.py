from bench.lib import stats
from bench.lib.stats import Record


def rec(rid, sent, stamps):
    return Record(rid=rid, client=rid, sent=sent, prompt_len=8, max_new=99,
                  greedy=True, stamps=list(stamps), tokens=[0] * len(stamps))


def steady(n_req=40, step=0.01, n_tok=200, stall_at=None, stall=0.0):
    recs = []
    for i in range(n_req):
        t, st = 0.0, []
        for k in range(n_tok):
            t += step
            if stall_at is not None and abs(t - stall_at) < step / 2 \
                    and i % 2 == 0:
                t += stall
            st.append(t + i * 1e-4)
        recs.append(rec(i, -1.0, st))
    return recs


def test_output_tok_s_counts_tokens_inside_the_window():
    recs = steady()
    assert abs(stats.output_tok_s(recs, 0.5, 1.5) - 40 * 100) < 40 * 2


def test_a_stall_inside_the_window_moves_tpot_p95():
    base = stats.end_to_end(steady(), 0.5, 1.5)["tpot_p95_ms"]
    stalled = stats.end_to_end(steady(stall_at=1.0, stall=0.3), 0.5, 1.5)
    assert abs(base - 10.0) < 0.1
    assert stalled["tpot_p95_ms"] > 1.3 * base
    outside = stats.end_to_end(steady(stall_at=1.8, stall=0.5), 0.5, 1.5)
    assert abs(outside["tpot_p95_ms"] - base) < 0.1


def test_ttft_is_of_requests_sent_inside_the_window():
    recs = [rec(0, 0.1, [0.3]), rec(1, 0.6, [0.65]), rec(2, 0.7, [0.9]),
            rec(3, 1.6, [1.7])]
    assert sorted(stats.ttfts(recs, 0.5, 1.5)) == \
        sorted([0.65 - 0.6, 0.9 - 0.7])


def test_percentile_interpolates():
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 0.95) == 4.8
    assert stats.percentile([], 0.95) == 0.0
