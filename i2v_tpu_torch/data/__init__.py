"""Clip sources (synthetic clips only, so far), the batcher and the prefetch
thread."""
