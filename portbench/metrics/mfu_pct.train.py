"""The window's analytic FLOPs (``work.train_step_flops`` a step: the
featurize FFTs, 3x the forward, AdamW) over its wall time, over the
precision's peak."""

from portbench.readers import mfu_pct as read  # noqa: F401
