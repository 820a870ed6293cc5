"""Model operations of the window's prefills (true prompt tokens) over
the seconds of its admissions at the bf16 peak, %: the whole prefill's
share. Reads ``mfu.prefill.<cell>``."""
from bench.lib import counts
from bench.metrics._common import prefill_flops, span_seconds


def read(ctx):
    s = sum(span_seconds(ctx, "admit"))
    ops = prefill_flops(ctx, ctx.ticks)
    return 100.0 * ops / (s * counts.PEAK_BF16_FLOPS) if s and ops else None
