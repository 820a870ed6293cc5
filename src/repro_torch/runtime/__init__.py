"""Serving runtime of the port: page allocator, greedy sampler, paged
engine and scheduler."""
