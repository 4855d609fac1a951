"""Host ms the prefetch thread spent on a batch: its read from disk, its
pin and the start of its upload (the program's spans ``ingest.read``,
``ingest.pin``, ``ingest.upload``), over the batches read, in the traced
window."""


def read(ctx):
    from i2v_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None:
        return None
    reads = totals("ingest.read")[0]
    host_s = sum(totals(f"ingest.{part}")[1] for part in ("read", "pin", "upload"))
    return 1e3 * host_s / reads if reads else None
