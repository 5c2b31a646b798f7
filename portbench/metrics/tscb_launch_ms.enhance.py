"""Host time of the ``cmgan.tscb`` spans of one batch (the program's spans
around its four two-stage conformer blocks, ~35 launches a conformer), mean
over the traced pass's batches. The traffic drains the device before each
of those dispatches, so the spans time the host's launches against an empty
launch queue, with the profiler on: what a small-batch path would wait on."""


def read(ctx):
    return ctx.facts.get("tscb_launch_ms")
