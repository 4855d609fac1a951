"""Device ms of a generation call's clean-tap forward (the program's span
``i2v.clean_taps``: the frames copied in and the surrogates' clean forward,
chunk by chunk), over the calls (spans ``i2v.call``) of the traced window."""


def read(ctx):
    from i2v_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None:
        return None
    calls = totals("i2v.call")[0]
    device_s = totals("i2v.clean_taps")[2]
    return None if not calls or device_s is None else 1e3 * device_s / calls
