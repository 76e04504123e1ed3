"""Model FLOPs of the window's steps (forward and twice it) over its length at the bf16 peak."""

from portbench.readers import train_mfu_pct as read  # noqa: F401
