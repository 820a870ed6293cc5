"""Serving runtime of the port: page allocator, greedy sampler, paged
engine with its metrics surface, scheduler and tracer."""
