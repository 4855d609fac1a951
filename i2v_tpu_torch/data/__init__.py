"""Clip sources and the batcher (synthetic clips only, so far)."""
