"""Model operations of the window's decode rows over the seconds of its
decode ticks at the bf16 peak, %: the whole decode step's share."""
from bench.lib import counts
from bench.metrics._common import decode_flops, span_seconds


def read(ctx):
    s = sum(span_seconds(ctx, "decode_tick"))
    ops = decode_flops(ctx, ctx.ticks)
    return 100.0 * ops / (s * counts.PEAK_BF16_FLOPS) if s and ops else None
