"""The training step's model FLOPs (the configuration's work file) over
the traced window, as a share of the H100's dense bf16 peak (%)."""

from portbench.lib import readers


def read(ctx):
    return readers.mfu(ctx)
