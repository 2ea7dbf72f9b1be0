"""The whole work's share of the four cards' bf16 peak, in %: the
algorithm's matmul operations at the global batch (`work/counts.
model_flops`) over rank 0's traced window."""
from portbench.work.readers import mfu


def read(ctx):
    return mfu(ctx)
