"""The byte bound of the window's decode steps (weights and the routed
experts once, each live row's K/V once, at the HBM peak) over the
window's seconds, %."""
from bench.lib import counts


def read(ctx):
    t0, t1 = ctx.window
    b = sum(counts.decode_step_bytes(ctx.dims, t.rows)
            for t in ctx.ticks if t.rows)
    return 100.0 * b / counts.PEAK_HBM_BYTES / (t1 - t0) if b else None
