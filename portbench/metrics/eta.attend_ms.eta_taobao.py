"""ETA's attention: the device time of the program's span ``eta.attend``
(the candidate's multi-head attention over the k picked steps and over the
recent steps, the latter computed over all L steps under its mask; forward
only), timed by the CUDA events the program's tracing records at the span's
ends, totalled over the profiled steps and divided by them (ms). None where
the program has no such span."""


def read(ctx):
    return ctx.get("device_span_ms", {}).get("eta.attend")
