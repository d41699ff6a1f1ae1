"""DIN's attention backward (kernel #5, all of its passes): the least time
of its work on the profiled batches over the device time of the kernels
named here (%)."""

from portbench.lib import readers

KERNELS = ("din_attention_bwd_kernel", "din_attention_bwd_tiles", "din_attention_bwd_plan",
           "din_attention_bwd_reduce")


def read(ctx):
    return readers.roofline(ctx, "attn_bwd", KERNELS)
