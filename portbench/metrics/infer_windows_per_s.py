"""10 s windows turned into motion per second, over all the work and time of the
window."""

from portbench.readers import samples_per_s as read  # noqa: F401
