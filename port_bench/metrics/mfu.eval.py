"""The whole work's share of the card's float32 peak, in %: the reference's
FLOPs of what the window completed, over the window."""

from port_bench.readers import mfu_percent as read  # noqa: F401
