"""Batch feed: the benchmark's host span around each ``Trainer.device_batch``
call, the mean over the window's steps (ms)."""

from portbench.lib import readers


def read(ctx):
    return readers.span_ms(ctx, "feed")
