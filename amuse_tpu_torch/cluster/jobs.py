"""Job templating and submission: the launcher's side of ``torch.distributed``.

Port of ``amuse_tpu/cluster/jobs.py``. Each job renders a self-contained
bash launch script (runnable under any scheduler that executes one: SLURM,
Kubernetes, ssh, or locally) and its state goes into a JSON ledger. JAX
runs one process per host and exports ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; torch runs one process per GPU,
so a job has ``num_hosts x procs_per_host`` ranks and each rank's script
exports torch's ``env://`` set (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), which
``amuse_tpu_torch.parallel.mesh.initialize_distributed`` reads.
"""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass(frozen=True)
class JobSpec:
    """Resource and command description (cluster_settings.json's counterpart)."""

    name: str
    command: list[str] = field(default_factory=list)
    env: dict = field(default_factory=dict)
    num_hosts: int = 1
    procs_per_host: int = 1  # one per GPU of a host
    max_runtime_hours: float = 8.0
    workdir: str = "."

    @property
    def world_size(self) -> int:
        return self.num_hosts * self.procs_per_host


SCRIPT_TEMPLATE = """#!/bin/bash
# generated by amuse_tpu_torch.cluster - job {name}
set -euo pipefail
cd {workdir}
{exports}
{dist_env}
exec timeout {timeout}s {command}
"""


def render_script(spec: JobSpec, rank: Optional[int] = None,
                  master: str = "localhost:29500") -> str:
    """The launch script of one rank of ``spec`` (``master`` is rank 0's
    ``host:port``). ``rank=None`` renders no distributed environment: the
    single-process script, as the JAX package's is at one host."""
    exports = "\n".join(f"export {k}={v!r}" for k, v in spec.env.items())
    dist_env = ""
    if rank is not None:
        if not 0 <= rank < spec.world_size:
            raise ValueError(f"rank {rank} outside a world of {spec.world_size}")
        addr, port = master.rsplit(":", 1)
        dist_env = "\n".join([
            f"export MASTER_ADDR={addr}",
            f"export MASTER_PORT={port}",
            f"export WORLD_SIZE={spec.world_size}",
            f"export RANK={rank}",
            f"export LOCAL_RANK={rank % spec.procs_per_host}",
        ])
    return SCRIPT_TEMPLATE.format(
        name=spec.name,
        workdir=spec.workdir,
        exports=exports,
        dist_env=dist_env,
        timeout=int(spec.max_runtime_hours * 3600),
        command=" ".join(spec.command),
    )


class JobLedger:
    """JSON-file job registry: submitted/running/finished with exit codes."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._jobs = json.loads(self.path.read_text()) if self.path.exists() else {}

    def record(self, name: str, **fields) -> None:
        self._jobs.setdefault(name, {}).update(fields, updated=time.time())
        self.path.write_text(json.dumps(self._jobs, indent=1))

    def get(self, name: str) -> dict:
        return self._jobs.get(name, {})

    def jobs(self) -> dict:
        return dict(self._jobs)


class LocalRunner:
    """Run jobs as local subprocesses (the no-cluster path; also what a
    per-host scheduler wrapper runs). Logs go to ``<out_dir>/<name>.log``,
    exit codes to the ledger."""

    def __init__(self, out_dir):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.ledger = JobLedger(self.out_dir / "ledger.json")

    def _start(self, name: str, script_text: str, env=None) -> subprocess.Popen:
        script = self.out_dir / f"{name}.sh"
        script.write_text(script_text)
        script.chmod(0o755)
        self.ledger.record(name, state="running", script=str(script))
        with open(self.out_dir / f"{name}.log", "w") as log:
            return subprocess.Popen(["bash", str(script)], stdout=log, stderr=log, env=env)

    def submit(self, spec: JobSpec, env=None) -> int:
        """Run ``spec`` as one process without a distributed environment;
        waits for it and returns its exit code."""
        rc = self._start(spec.name, render_script(spec), env).wait()
        self.ledger.record(spec.name, state="finished", exit_code=rc)
        return rc

    def submit_multihost(self, spec: JobSpec, master: str = "localhost:29500",
                         env=None) -> list[int]:
        """Launch every rank of ``spec`` here, each from its own rendered
        script (``<name>.r<rank>.sh``, the world size 1 included) carrying its
        ``RANK`` and ``LOCAL_RANK`` beside the shared ``MASTER_ADDR`` /
        ``MASTER_PORT`` / ``WORLD_SIZE``: what per-host scheduler wrappers
        would run on a cluster. Blocks until every rank exits; returns the
        exit codes in rank order."""
        procs = []
        for rank in range(spec.world_size):
            name = f"{spec.name}.r{rank}"
            procs.append((name, self._start(name, render_script(spec, rank, master), env)))
        rcs = []
        for name, proc in procs:
            rc = proc.wait()
            self.ledger.record(name, state="finished", exit_code=rc)
            rcs.append(rc)
        return rcs
