"""Share of rank 0's traced window with no kernel or copy on its card,
in %."""


def read(ctx):
    return 100.0 * ctx["trace"].idle_share()
