"""Model FLOPs of the clips' windows over the window's length at the bf16 peak."""

from portbench.readers import infer_mfu_pct as read  # noqa: F401
