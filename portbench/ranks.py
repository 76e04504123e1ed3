"""A cell on more than one card: one process a card on this host, started
with the ``env://`` variables that ``amuse_tpu_torch/cluster/jobs.py``
renders, and what keeps those processes in step.

``launch`` starts the ranks and waits for them. A rank that exits with
another code than 0 ends the others: each gets SIGTERM at once and SIGKILL
``GRACE_S`` seconds later, so a rank left waiting in a collective on a
peer that died never hangs the run. The ranks also get SIGTERM when the
process that started them dies.

``Solo`` (one card, no process group) and ``Group`` (a rank of a process
group) give the harness the same few calls: rank 0's decision to go on,
read by every rank between two requests over a gloo group (a host-side
broadcast: no device sync); a gather of host values to every rank; a
barrier. ``Solo``'s are the identity, so a one-card cell runs what it ran
before there were ranks.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

GRACE_S = 15.0
POLL_S = 0.2
# The card machine has no network: the ranks of one host bootstrap over
# loopback; the cards reach each other over NVLink.
RANK_ENV = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"}
_PR_SET_PDEATHSIG = 1


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, rank: int, port: int, base: dict | None = None) -> dict:
    """The environment of one rank of ``world`` on this host."""
    env = dict(os.environ if base is None else base)
    for key, value in RANK_ENV.items():
        env.setdefault(key, value)
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               RANK=str(rank), LOCAL_RANK=str(rank))
    return env


def _die_with_parent(libc) -> None:  # runs in the child between fork and exec
    libc.prctl(_PR_SET_PDEATHSIG, signal.SIGTERM)


@dataclass
class Launched:
    """What the ranks left: the first failing rank's code (0 when all
    succeeded, 124 when ``timeout_s`` ran out) and each rank's stdout and
    stderr lines."""

    rc: int
    stdout: list = field(default_factory=list)
    stderr: list = field(default_factory=list)
    failed_rank: int | None = None


def _pump(stream, sink: list, prefix: str | None) -> None:
    for line in stream:
        sink.append(line.rstrip("\n"))
        if prefix is not None:
            sys.stderr.write(prefix + line)
            sys.stderr.flush()
    stream.close()


def launch(argv: list[str], world: int, timeout_s: float, env: dict | None = None) -> Launched:
    """Run ``python3 argv`` as ranks 0 .. world - 1 and wait for them.

    Each rank's stderr is passed on as it comes, each line headed by its
    rank; stdout is kept. Returns once every rank has ended."""
    port, libc = free_port(), ctypes.CDLL(None)
    procs = [subprocess.Popen([sys.executable, *argv], env=rank_env(world, r, port, env),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              preexec_fn=lambda: _die_with_parent(libc))
             for r in range(world)]
    out = Launched(0, [[] for _ in procs], [[] for _ in procs])
    pumps = [threading.Thread(target=_pump, args=(p.stdout, out.stdout[r], None), daemon=True)
             for r, p in enumerate(procs)]
    pumps += [threading.Thread(target=_pump, args=(p.stderr, out.stderr[r], f"[rank {r}] "),
                               daemon=True) for r, p in enumerate(procs)]
    for t in pumps:
        t.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                out.failed_rank = failed[0] if failed else None
                out.rc = procs[failed[0]].returncode if failed else 124
                break
            time.sleep(POLL_S)
    finally:
        _end(procs)
    for t in pumps:
        t.join(GRACE_S)
    if out.rc == 0:
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            out.failed_rank, out.rc = failed[0], procs[failed[0]].returncode
    return out


def _end(procs: list) -> None:
    """SIGTERM to every rank still running, SIGKILL ``GRACE_S`` later."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    stop = time.monotonic() + GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, stop - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class Solo:
    """One card, no process group."""

    rank, size = 0, 1

    def go(self, flag: bool) -> bool:
        return flag

    def gather(self, value) -> list:
        return [value]

    def agree(self, short: str) -> str:
        return short

    def barrier(self) -> None:
        pass


class Group:
    """This process as one rank of the default process group; host values
    travel over the program's gloo group (``parallel/mesh.py::host_group``)."""

    def __init__(self):
        import torch.distributed as dist

        from amuse_tpu_torch.parallel import mesh

        self.dist, self.group = dist, mesh.host_group()
        self.rank, self.size = dist.get_rank(), dist.get_world_size()

    def go(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        import torch

        box = torch.tensor([int(flag)], dtype=torch.int32)
        self.dist.broadcast(box, 0, group=self.group)
        return bool(box.item())

    def gather(self, value) -> list:
        """Every rank's ``value`` (a picklable host object), in rank order."""
        out = [None] * self.size
        self.dist.all_gather_object(out, value, group=self.group)
        return out

    def agree(self, short: str) -> str:
        """What any rank found short, so that every rank retries together."""
        return "; ".join(f"rank {r}: {s}" for r, s in enumerate(self.gather(short)) if s)

    def barrier(self) -> None:
        self.dist.barrier(group=self.group)


def join(device_type: str) -> tuple:
    """Join the process group the launcher's environment describes, over
    NCCL on ``cuda:LOCAL_RANK`` (gloo on the CPU), and open its
    communicators and the gloo group at once -> (device, ``Group``, the
    seconds each took)."""
    import torch
    import torch.distributed as dist

    from amuse_tpu_torch.parallel import mesh

    t = time.perf_counter()
    device = mesh.initialize_distributed(device_type)
    stages = {"join_s": time.perf_counter() - t}
    t = time.perf_counter()
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)  # the first collective opens NCCL's communicators
    if probe.item() != dist.get_world_size():
        raise RuntimeError(f"an all-reduce of ones over {dist.get_world_size()} ranks read "
                           f"{probe.item()}")
    group = Group()
    group.barrier()
    stages["first_collective_s"] = time.perf_counter() - t
    return device, group, stages
