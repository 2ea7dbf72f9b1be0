"""Kernel A's share of its roofline, in %: the least time of the
forward attention calls the cluster plan fixes over the device time of
the `attn_fwd` family."""
from portbench.work.readers import attention


def read(ctx):
    return attention(ctx, backward=False)
