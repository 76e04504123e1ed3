"""Share of the slice's requests, run untraced, in which no operation traced on the device ran."""

from portbench.readers import device_idle_pct as read  # noqa: F401
