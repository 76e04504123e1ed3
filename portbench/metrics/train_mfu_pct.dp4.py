"""Model FLOPs of the window's global steps (forward and twice it) over its length at the bf16
peak of the cell's four cards."""

from portbench.readers import train_mfu_pct as read  # noqa: F401
