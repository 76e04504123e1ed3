"""Job launch scripts and hyper-parameter sweeps (the port's copies of
amuse_tpu/cluster/jobs.py and sweep.py)."""
