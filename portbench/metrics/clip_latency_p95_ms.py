"""95th percentile of all clips' latency in the window, from the call to numpy back."""

from portbench.readers import latency_p95_ms as read  # noqa: F401
