"""K2r's device time (the port's kernel ``attention_relpos``, which the op
``sevit::attention_relpos_fwd`` launches) in the traced slice against the
bound on its work (``cmgan_work.relpos_work``): operations over the kept keys
at 3xTF32's rate, or Q, K, V, O and the table once over HBM's, whichever is
larger, call by call."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("attention_relpos",), ctx.facts.get("traced_relpos"),
                        "attention_fp32")
