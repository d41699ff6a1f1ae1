"""Launches a training step: the median over the profiled steps of the
device operations (kernels, copies, fills) from one step's feed copies to
the next's (``spans.launches_per_step``), so that neither operations
launched before the profiler started nor records the trace lost move it.
The shapes fix it."""

from portbench.lib import spans


def read(ctx):
    return spans.launches_per_step(ctx)
