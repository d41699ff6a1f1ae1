"""The train step's model forward and backward: the device span from the
step's ``forward`` mark to its ``optimizer`` mark (``Trainer.step_marks``),
totalled over the window's steps and divided by them (ms)."""

from portbench.lib import readers


def read(ctx):
    return readers.mark_ms(ctx, "forward", "optimizer")
