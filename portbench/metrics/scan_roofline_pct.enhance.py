"""The selective scan's device time (the port's kernel ``selective_scan``,
which the op ``sevit::selective_scan`` launches) in the traced slice against
the bound on its work (``semamba_work.scan_work``): its exponentials at the
SFU's rate, counted as 16 fp32 operations each, or u, delta, z, B, C read
and y written once over HBM's, whichever is larger, over the valid steps,
call by call."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("selective_scan",), ctx.facts.get("traced_scan"), "fp32")
