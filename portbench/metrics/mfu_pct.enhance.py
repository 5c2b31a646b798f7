"""The window's analytic FLOPs (forward at each batch's bucket and rows,
and the STFT's and iSTFT's FFTs) over its wall time, over the precision's
peak."""

from portbench.readers import mfu_pct as read  # noqa: F401
