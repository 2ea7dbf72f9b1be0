"""Mean host wait for a batch a step, in ms: the host clock around each
`next()` of the loader that the trainer makes in the traced window."""


def read(ctx):
    waits = ctx.get("data_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
