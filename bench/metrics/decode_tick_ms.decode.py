"""Mean host milliseconds of a decode tick in the window (the engine's
``decode_tick`` span: page top-up, the graph replay and its one copy
back)."""
from bench.metrics._common import span_seconds


def read(ctx):
    s = span_seconds(ctx, "decode_tick")
    return 1e3 * sum(s) / len(s) if s else None
