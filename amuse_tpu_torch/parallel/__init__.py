"""Data parallelism over torch.distributed (the port of amuse_tpu/parallel)."""
