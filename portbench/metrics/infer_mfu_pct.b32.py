"""Model FLOPs of the b32 window's windows over its length at the bf16 peak."""

from portbench.readers import infer_mfu_pct as read  # noqa: F401
