"""Model operations of every token the window processed (true prompt
tokens, decode rows) over the window's seconds at the bf16 peak, %."""
from bench.lib import counts
from bench.metrics._common import decode_flops, prefill_flops


def read(ctx):
    t0, t1 = ctx.window
    ops = prefill_flops(ctx, ctx.ticks) + decode_flops(ctx, ctx.ticks)
    return 100.0 * ops / ((t1 - t0) * counts.PEAK_BF16_FLOPS) if ops else None
