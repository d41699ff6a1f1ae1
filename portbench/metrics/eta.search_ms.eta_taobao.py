"""ETA's search: the device time of the program's span ``eta.search`` (the
SimHash codes of the candidate and of every step, their Hamming
similarity, the top-k and the gather of the picks; forward only, as the
search has no backward but the gather's), timed by the CUDA events the
program's tracing records at the span's ends, totalled over the profiled
steps and divided by them (ms). None where the program has no such span."""


def read(ctx):
    return ctx.get("device_span_ms", {}).get("eta.search")
