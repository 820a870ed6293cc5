"""The prefill MHA kernel's bound (the larger of its causal operations
over the true prompt at the bf16 peak and its q, k, v, o bytes at the
HBM peak) of the prefills the profiler saw, over its device time there,
%. Reads ``mha_roofline.<cell>``."""
from bench.lib import counts
from bench.metrics._common import kernel_seconds


def read(ctx):
    dev = kernel_seconds(ctx, "mha_")
    if not dev:
        return None
    dm = ctx.dims
    bound = 0.0
    for t in ctx.prof.ticks:
        for L in t.prefills:
            ops = counts.mha_flops(dm, L) / counts.PEAK_BF16_FLOPS
            io = (2 * dm.heads + 2 * dm.kv_heads) * dm.head_dim * L \
                * counts.BYTES * dm.layers / counts.PEAK_HBM_BYTES
            bound += max(ops, io)
    return 100.0 * bound / dev if bound else None
