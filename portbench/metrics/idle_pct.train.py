"""Share of the untraced window with no operation running on the device:
the traced slice's device seconds per FLOP at the window's rate."""

from portbench.readers import window_idle_pct as read  # noqa: F401
