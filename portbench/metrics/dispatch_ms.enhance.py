"""Mean host time of one ``enhance_batch_async`` call in the window (the
benchmark's ``dispatch`` span): padding, pinned staging, enqueue."""

from portbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "dispatch")
