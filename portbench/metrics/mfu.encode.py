"""The whole work's share of the card's bf16 peak, in %: the
algorithm's matmul operations (`work/counts.model_flops`) over the traced
window."""
from portbench.work.readers import mfu


def read(ctx):
    return mfu(ctx)
