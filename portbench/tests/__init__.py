"""CPU tests of the benchmark (run: ``python -m pytest portbench/tests -q``
from the repository's root). Tests marked ``gpu`` need a CUDA card and
skip without one."""
