"""The stage-1 train step of ``amuse_tpu_torch`` data-parallel over the
ranks of a process group, as ``train_audio`` runs it under the ``env://``
launcher: ``make_train_step(tcfg, grad_sync=...)`` on every rank, the
gradients all-reduced over NCCL in ``parallel/mesh.py``'s flat buckets
(``BUCKET_BYTES``), the fusion and decoder on the batch gathered across
ranks.

Each rank draws the same weights from the seed on its own card (then
``mesh.replicate`` checks that every rank holds rank 0's). Rank 0 makes the
pool of quads and broadcasts it; each rank holds the whole pool in host
memory and copies its own rows of each global batch (``GradSync.rows``) to
its card. A request is one global step: its
``samples`` are the global batch, every rank's rows together. The step's
``GradSync`` is ``TimedSync``, which times each all-reduce on the card
between two CUDA events, from the first bucket's ``cat`` to the last
unflatten, and syncs nothing.

The checked steps run in set-up as ``systems/stage1.py`` runs them; each
rank then reads a digest of its parameters (each leaf's float64 sum and
sum of squares) and the ranks exchange them. After the window, once every
rank has freed the program, rank 0 alone runs the plain reference over the
same global batches and judges its own readings against it, as
``stage1.q8`` is judged, and counts the leaves on which any rank's
parameters differ from rank 0's (``replicas_apart``: replicas of one
all-reduced step agree bit for bit).
"""

from __future__ import annotations

import collections
import statistics
from unittest import mock

import numpy as np
import torch

from amuse_tpu_torch.parallel import mesh as mesh_mod
from amuse_tpu_torch.parallel.mesh import GradSync
from portbench import ranks
from portbench.generator import Request
from portbench.systems import stage1
from portbench.systems.stage1 import rows

ENTRIES = stage1.ENTRIES
# the readings that need the reference alone run on one card, as stage1.q8's
control_reading = stage1.control_reading
fault_reading = stage1.fault_reading


class TimedSync(GradSync):
    """The program's ``GradSync``; on a card each ``all_reduce`` is timed
    between two CUDA events recorded on the step's stream."""

    def __init__(self, mesh, device: torch.device):
        super().__init__(mesh)
        self.timed = device.type == "cuda"
        self.events = collections.deque(maxlen=64)

    def all_reduce(self, params) -> None:
        if not self.timed:
            super().all_reduce(params)
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        super().all_reduce(params)
        end.record()
        self.events.append((start, end))

    def last_ms(self, n: int) -> list:
        """The device ms of the last ``n`` all-reduces (the device has done them)."""
        return [s.elapsed_time(e) for s, e in list(self.events)[-n:]]


def exchange_left_out():
    """The fault of a data-parallel step, as a context: every rank steps on
    its own gradient (``TimedSync.all_reduce`` does nothing)."""
    return mock.patch.object(TimedSync, "all_reduce", lambda self, params: None)


def _digests(named: dict) -> np.ndarray:
    """(leaves, 2) float64: each leaf's sum and sum of squares."""
    return torch.stack([torch.stack([p.detach().double().sum(), p.detach().double().square().sum()])
                        for p in named.values()]).cpu().numpy()


class Session(stage1.Session):
    def __init__(self, cfg: dict, mix: dict, settings: dict, seed: int, device: torch.device):
        self.mesh = mesh_mod.current_mesh()
        if self.mesh is None:
            raise RuntimeError("stage1_dp runs as the ranks of a process group (portbench/ranks.py)")
        self.group = ranks.Group()
        self.grad_sync = TimedSync(self.mesh, device)
        world = self.grad_sync.size
        if any(int(n) % world for n in mix["samples_per_request"]):
            raise ValueError(f"a global batch of {mix['samples_per_request']} quads does not "
                             f"divide over {world} ranks")
        super().__init__(cfg, mix, settings, seed, device)

    def _make_pool(self) -> dict:
        """Rank 0's pool, made once and broadcast from its card to every
        rank's over the process group, then held in each rank's host memory."""
        pool = super()._make_pool() if self.group.rank == 0 else None
        box = [None if pool is None else {k: (v.shape, str(v.dtype)) for k, v in pool.items()}]
        self.group.dist.broadcast_object_list(box, 0, group=self.group.group)
        out = {}
        for k, (shape, dtype) in box[0].items():
            if pool is not None:
                self.group.dist.broadcast(torch.from_numpy(pool[k]).to(self.device), 0)
                out[k] = pool[k]
            else:
                t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                device=self.device)
                self.group.dist.broadcast(t, 0)
                out[k] = t.cpu().numpy()
        return out

    def _first_steps(self) -> dict:
        """Rank 0's weights on every rank (checked), the checked steps as
        ``stage1.Session`` runs them, every rank's digest."""
        mesh_mod.replicate([self.state.model], self.mesh)
        out = super()._first_steps()
        out["digests"] = self.group.gather(_digests(dict(self.state.model.named_parameters())))
        return out

    def _batch(self, r: Request) -> dict:
        """This rank's rows of the global batch."""
        return {k: v[self.grad_sync.rows(r.samples // self.grad_sync.size)]
                for k, v in rows(self.pool, r.start, r.samples).items()}

    def slice_readings(self, n: int) -> dict:
        """The all-reduce's device ms a step over the last ``n`` steps."""
        ms = self.grad_sync.last_ms(n)
        return {"grad_sync_ms": statistics.fmean(ms)} if len(ms) == n and n else {}

    def slice_flops(self, requests: list[Request]) -> dict:
        """The attention kernels' work on this rank's rows."""
        world = self.grad_sync.size
        return super().slice_flops([Request(r.index, r.samples // world, r.start, r.seed)
                                    for r in requests])

    def release(self) -> None:
        """The program's state and its mesh's data group (its communicators)."""
        super().release()
        group = mesh_mod.data_group(self.mesh)
        if group is not torch.distributed.group.WORLD:
            torch.distributed.destroy_process_group(group)
        del self.mesh, self.grad_sync

    def check(self, done: list) -> dict | None:
        """Rank 0: ``stage1.Session.check`` against the reference on the
        global batches, and ``replicas_apart``; every other rank: None."""
        if self.group.rank != 0:
            return None
        digests = self.first["digests"]
        apart = sum(any(not np.array_equal(d[i], digests[0][i]) for d in digests[1:])
                    for i in range(len(digests[0])))
        return {**super().check(done), "replicas_apart": float(apart)}
