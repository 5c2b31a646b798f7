"""Requests per batch the dynamic batcher formed in the window: the change
of its own counters (``batched_requests`` over ``batches``)."""


def read(ctx):
    f = ctx.facts
    return f["batched_requests"] / f["batches"] if f.get("batches") else None
