"""Kernel E's share of its roofline, in %, on the work that the
shapes alone fix (a lower bound: the Lloyd steps and member sums are left
out)."""
from portbench.work.readers import kmedoids


def read(ctx):
    return kmedoids(ctx)
