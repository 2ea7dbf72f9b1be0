"""Device ms a step of the kernels that `torch.linalg.eigh` launches for
spectral clustering's eigensolve (family `eigh`)."""
from portbench.work.readers import family_ms


def read(ctx):
    return family_ms(ctx, "eigh")
