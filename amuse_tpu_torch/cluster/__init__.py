"""Hyper-parameter sweeps (the port's copy of amuse_tpu/cluster/sweep.py)."""
