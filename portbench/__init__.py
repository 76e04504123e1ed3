"""The benchmark of the PyTorch/CUDA port (``amuse_tpu_torch``).

One command runs one cell once (see ``run.py``). Everything that belongs to
one configuration, traffic mix, cell or metric is a file of its own, found
by the name that ``BENCHMARK.json`` gives it:

  configs/<config>.json    sizes, types and the kernel sources a config builds
  traffic/<mix>.json       the parameters the one traffic generator reads
  workloads/<cell>.json    the cell's check (sample, limits) and traced slice, and
                           the system that drives it where not the config's
  metrics/<metric>.py      a reader: ``read(ctx) -> float | None``
  reference/<name>.py      the plain float32 reference a config names

A cell on several cards runs one process a card (``ranks.py``). Nothing
here imports JAX or the JAX package ``amuse_tpu``; ``reference/`` imports
nothing of the program either.
"""
