"""The embedding engine and the optimizer: the device span from the step's
``optimizer`` mark to its ``metrics`` mark (the dense chain's Adam, and in
the fused engine #9 and the tables' Adam), totalled over the window's steps
and divided by them (ms)."""

from portbench.lib import readers


def read(ctx):
    return readers.mark_ms(ctx, "optimizer", "metrics")
