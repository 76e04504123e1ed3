"""Device ms a step of the fused Adam kernels (torch.optim.Adam(fused=True)) on rank 0's card,
by kernel name."""

from portbench.readers import kernels_ms_per_request


def read(ctx):
    return kernels_ms_per_request(ctx, "Adam")
