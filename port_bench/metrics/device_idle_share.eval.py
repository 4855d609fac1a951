"""The device's idle share of the window, in %: 1 − the union of the device
operations' intervals over the harness's window span (traced run)."""

from port_bench.readers import idle_percent as read  # noqa: F401
