"""Device ms a gallery batch of host-to-device copies (family `h2d`)."""
from portbench.work.readers import family_ms


def read(ctx):
    return family_ms(ctx, "h2d")
