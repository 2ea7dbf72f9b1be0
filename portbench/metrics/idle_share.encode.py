"""Share of the traced window with no kernel or copy on the card, in
%."""


def read(ctx):
    return 100.0 * ctx["trace"].idle_share()
