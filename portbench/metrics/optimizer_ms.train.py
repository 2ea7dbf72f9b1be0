"""Device ms a step of the optimizer's foreach kernels (family
`optimizer`)."""
from portbench.work.readers import family_ms


def read(ctx):
    return family_ms(ctx, "optimizer")
