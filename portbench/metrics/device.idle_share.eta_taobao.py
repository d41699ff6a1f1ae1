"""The share of the profiled training steps' span in which the device ran
no kernel, copy or fill: the gaps in the union of the trace's device
intervals (%)."""

from portbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)
