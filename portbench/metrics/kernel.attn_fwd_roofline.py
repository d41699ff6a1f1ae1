"""DIN's attention forward (kernel #4): the least time of its
work on the profiled batches over the device time of the kernels named
here (%)."""

from portbench.lib import readers

KERNELS = ("din_attention_tc_kernel", "din_attention_fma_kernel")


def read(ctx):
    return readers.roofline(ctx, "attn_fwd", KERNELS)
