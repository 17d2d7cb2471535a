"""Share of the traced window in which the card ran nothing."""

from kbench.readers import device_idle_pct as read  # noqa: F401
