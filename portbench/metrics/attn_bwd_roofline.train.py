"""Kernel B's share of its roofline, in %."""
from portbench.work.readers import attention


def read(ctx):
    return attention(ctx, backward=True)
