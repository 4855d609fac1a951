"""Host ms the evaluation loop waited for each uploaded batch (the
program's span ``eval.ingest_wait``: one blocking take from the prefetch
thread a batch), over those waits, in the traced window."""


def read(ctx):
    from i2v_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None:
        return None
    count, host_s, _ = totals("eval.ingest_wait")
    return 1e3 * host_s / count if count else None
