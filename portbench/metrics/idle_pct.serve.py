"""Share of the traced slice with no operation running on the device."""

from portbench.readers import slice_idle_pct as read  # noqa: F401
