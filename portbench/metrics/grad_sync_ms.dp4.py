"""Device ms a step of the gradients' all-reduce (``parallel/mesh.py``'s flat buckets: copies in,
NCCL, the mean, copies out), between CUDA events around ``GradSync.all_reduce`` on rank 0, over
the traced slice."""


def read(ctx):
    return ctx.slice_readings.get("grad_sync_ms")
