"""K2's device time (the port's kernel ``attention_fwd``, which the op
``sevit::attention_fwd`` launches) in the traced slice against the bound on
its work: operations over the kept keys at 3xTF32's rate, or Q, K, V and O
once over HBM's, whichever is larger."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("attention_fwd",), ctx.facts.get("traced_attention"),
                        "attention_fp32")
