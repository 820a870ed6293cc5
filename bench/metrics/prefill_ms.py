"""Mean host milliseconds of an admission in the window (the engine's
``admit`` span: the bucketed prefill through the MHA kernel, its cache
scatter and its first token, read back on the host). Reads
``prefill_ms.<cell>`` of each prompt-heavy cell, one name a tail it
moves."""
from bench.metrics._common import span_seconds


def read(ctx):
    s = span_seconds(ctx, "admit")
    return 1e3 * sum(s) / len(s) if s else None
