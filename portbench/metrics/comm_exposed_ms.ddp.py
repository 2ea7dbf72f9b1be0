"""Rank 0's device ms a step of the `nccl` family (the gradient
all-reduce, the features' all-gather, the losses' sum) with no kernel of
another family running on its card: the exchange that the backward does
not hide."""


def read(ctx):
    trace, units = ctx["trace"], ctx["units"]
    if not units or trace.family_s().get("nccl", 0.0) <= 0.0:
        return None
    return 1e3 * trace.exposed_s("nccl") / units
