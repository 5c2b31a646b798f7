"""Host time of the ``semamba.tfmamba`` spans of one batch (the program's
spans around its four TFMamba blocks), mean over the traced pass's batches.
The traffic drains the device before each of those dispatches, so the spans
time the host's launches against an empty launch queue, with the profiler
on: what a small-batch path would wait on."""


def read(ctx):
    return ctx.facts.get("tfmamba_launch_ms")
