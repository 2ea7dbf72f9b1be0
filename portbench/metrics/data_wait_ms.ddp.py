"""Rank 0's mean host wait for its shard of a batch a step, in ms: the
host clock around each `next()` of its loader that the trainer makes in
the traced window, while the other ranks' loaders share the host."""


def read(ctx):
    waits = ctx.get("data_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
