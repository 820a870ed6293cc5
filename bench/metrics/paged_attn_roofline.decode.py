"""The paged-decode kernel's byte bound (each live row's K/V, query and
output, every layer, of the steps the profiler saw) over its device time
there, %."""
from bench.lib import counts
from bench.metrics._common import kernel_seconds


def read(ctx):
    dev = kernel_seconds(ctx, "paged_decode")
    if not dev:
        return None
    b = sum(counts.paged_bytes(ctx.dims, k)
            for t in ctx.prof.ticks for k in t.rows)
    return 100.0 * b / counts.PEAK_HBM_BYTES / dev if b else None
