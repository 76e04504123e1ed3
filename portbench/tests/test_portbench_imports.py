"""In a fresh interpreter: what the benchmark loads, compared by whole
top-level module names (``amuse_tpu_torch`` is the program and allowed;
``amuse_tpu`` is the JAX package and is not)."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.run import FORBIDDEN
from portbench.tests.tiny import ROOT

RUN_MODULES = """
import glob, importlib, json, os, sys
import portbench.run, portbench.control, portbench.systems.infer, portbench.systems.stage1
import portbench.ranks, portbench.systems.stage1_dp
import portbench.reference.infer, portbench.reference.stage1
import amuse_tpu_torch.infer.pipeline, amuse_tpu_torch.ops.attention, amuse_tpu_torch.train.audio
from portbench import manifest
for path in glob.glob(os.path.join("portbench", "metrics", "*.py")):
    manifest.reader(os.path.basename(path)[:-3])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import json, sys
import portbench.reference.infer, portbench.reference.fbank, portbench.reference.stage1
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax_package():
    loaded = _top_level(RUN_MODULES)
    assert "amuse_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & ({"amuse_tpu_torch"} | set(FORBIDDEN))
