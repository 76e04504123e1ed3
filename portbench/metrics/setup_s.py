"""From process start to the first timed request: imports, CUDA init, the kernels
(built in a checkout's first run), weights, data and warm-up."""

from portbench.readers import setup_s as read  # noqa: F401
