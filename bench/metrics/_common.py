"""What several readers share: the window's operations and the spans'
seconds. Not a metric: no entry of BENCHMARK.json names it."""
from bench.lib import counts


def prefill_flops(ctx, ticks) -> int:
    return sum(counts.prefill_flops(ctx.dims, L)
               for t in ticks for L in t.prefills)


def decode_flops(ctx, ticks) -> int:
    return sum(counts.decode_row_flops(ctx.dims, k)
               for t in ticks for k in t.rows)


def span_seconds(ctx, name: str):
    return [d for n, _, d in ctx.spans if n == name]


def kernel_seconds(ctx, fragment: str) -> float:
    if ctx.prof is None:
        return 0.0
    return sum(d for n, _, d in ctx.prof.events if fragment in n)
