"""K2 and its backward (the port's kernels ``attention_fwd`` and
``attention_bwd``, under the ops ``sevit::attention_fwd`` and
``sevit::attention_bwd``) in the traced slice against the bound on their
work: the backward counts 2.5x the forward's operations."""

from portbench.readers import roofline_pct


def read(ctx):
    works = [w for fwd_bwd in ctx.facts.get("traced_attention", []) for w in fwd_bwd]
    return roofline_pct(ctx, ("attention_fwd", "attention_bwd"), works, "attention_fp32")
