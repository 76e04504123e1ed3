"""Data parallelism over ``torch.distributed``: one process per GPU.

Port of ``amuse_tpu/parallel/mesh.py``. The JAX package is SPMD over one
global batch on a device mesh: ``P("data")`` gives each device contiguous
rows, a replicated tree is the same on every device, and XLA emits the
gradient reduction. Here each rank is one process on ``cuda:LOCAL_RANK`` (or
the CPU under gloo), and the same semantics are spelled out:

  * ``shard_rows``: this rank's contiguous rows of a global batch;
  * ``replicate``: parameters and buffers broadcast from rank 0, checked bit
    for bit against every rank's own copy;
  * ``all_reduce_grads``: the gradients' mean over the data group, in
    bounded flat buckets, between ``backward`` and the optimizer's step;
  * ``mean_logs``: the logged scalars' mean over the data group, which is the
    global batch's value of a loss that is a mean over equal shares of rows;
  * ``gather_batch``: the global batch of a tensor on every rank, for the
    stage-1 fusion and decoder, whose attention mixes the rows of a batch;
  * ``gather_rows`` and ``sharded_rows_fn``: host-side results (cache rows,
    fbanks) gathered over a gloo group, since NCCL gathers no CPU tensor and
    gloo no CUDA one.

The models are not wrapped in ``DistributedDataParallel``: the train steps
call them through methods other than ``forward`` (``encode``, ``decode``,
``reconstruct``), where DDP never prepares its reducer. The steps call
``GradSync`` explicitly instead.

A process without the launcher's environment (``WORLD_SIZE`` unset) creates
no process group and takes no collective: for ``mesh=None`` every function
here is the identity or its single-process meaning.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from amuse_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BUCKET_BYTES = 64 << 20  # gradients all-reduced per flat bucket


def initialize_distributed(device: str | torch.device = "cuda", backend: Optional[str] = None,
                           init_method: str = "env://") -> torch.device | bool:
    """Join the process group the launcher's environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, and ``MASTER_ADDR`` /
    ``MASTER_PORT`` for ``env://``; ``cluster/jobs.py`` renders them).

    Returns False, and does nothing, when ``WORLD_SIZE`` is unset. Otherwise
    it initializes, world size 1 included, and returns this rank's device:
    ``cuda`` becomes ``cuda:LOCAL_RANK`` (an explicit ``cuda:<i>`` is kept)
    under NCCL, ``cpu`` runs gloo. ``backend`` names another backend (gloo
    on the card); nothing falls back from one backend to another.
    """
    if "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if init_method == "env://":
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(f"WORLD_SIZE is set but {', '.join(missing)} is not")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ``DeviceMesh`` of shape (n_data, n_model) over the process group,
    with dims named ("data", "model") as JAX's; every rank on the data axis
    by default. Raises without a process group (it would otherwise start one)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh does not cover {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def current_mesh():
    """``make_mesh()`` when this process is one rank of a group, else None."""
    return make_mesh() if dist.is_initialized() else None


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def data_group(mesh):
    return mesh.get_group(DATA_AXIS)


def is_main(mesh) -> bool:
    """Whether this process writes the run's files (rank 0, or no group)."""
    return mesh is None or dist.get_rank() == 0


def is_local_main(mesh) -> bool:
    """Whether this process does a host's one-per-host work (local rank 0, or
    no group): ``LOCAL_RANK`` as the launcher set it."""
    return mesh is None or int(os.environ.get("LOCAL_RANK", "0")) == 0


_HOST_GROUPS: dict = {}  # default group -> its gloo twin (NCCL runs only)


def host_group():
    """A gloo group over every rank, for host-side gathers and barriers: the
    default group under gloo, else one gloo group made at the first call
    (every rank must make that call at the same point of its program)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    world = dist.group.WORLD  # kept as the key: a new default group is a new key
    if world not in _HOST_GROUPS:
        _HOST_GROUPS[world] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[world]


def barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier(group=host_group())


def broadcast_object(obj: Any, mesh) -> Any:
    """Rank 0's ``obj`` on every rank (a picklable host object)."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_rows(batch, mesh):
    """This rank's contiguous rows of every leaf (numpy array or tensor) of a
    global batch (JAX: ``shard_batch``). Raises when a leading dim does not
    divide by the data axis."""
    if mesh is None:
        return batch
    n, r = data_size(mesh), data_rank(mesh)

    def take(x):
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"leading dim {rows} is not divisible by the data axis ({n})")
        k = rows // n
        return x[r * k:(r + 1) * k]

    return _tree_map(take, batch)


def _buckets(tensors: list, bucket_bytes: int) -> list:
    """Consecutive tensors of one dtype, at most ``bucket_bytes`` a bucket
    (a larger tensor is a bucket of its own)."""
    out, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != cur[0].dtype or size + nbytes > bucket_bytes):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def _unflatten_into(flat: torch.Tensor, tensors: list) -> None:
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def replicate(modules: Iterable[torch.nn.Module], mesh) -> None:
    """Broadcast every parameter and buffer of ``modules`` from the data
    group's rank 0, in place; raise on every rank when any rank's own copy
    differed (ranks built from one seed or one checkpoint must agree)."""
    if mesh is None:
        return
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    tensors = [t.data for m in modules for t in (*m.parameters(), *m.buffers())]
    if not tensors:
        return
    differ = torch.zeros((), dtype=torch.int32, device=tensors[0].device)
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        mine = flat.clone()
        dist.broadcast(flat, src, group=group)
        differ += (flat != mine).any().int()
        _unflatten_into(flat, bucket)
    dist.all_reduce(differ, group=group)
    if differ.item():
        raise RuntimeError("ranks disagree on the replicated parameters or buffers "
                           f"({differ.item()} rank-buckets differed from rank 0's)")


def all_reduce_grads(params: Iterable[torch.Tensor], mesh) -> None:
    """Each gradient becomes its mean over the data group: flat buckets of at
    most ``BUCKET_BYTES``, summed and divided by the group's size. A ``None``
    gradient stays ``None`` (every rank runs the same program, so the same
    parameters get none)."""
    if mesh is None:
        return
    group, n = data_group(mesh), data_size(mesh)
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads, BUCKET_BYTES):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        _unflatten_into(flat, bucket)


def mean_logs(logs: dict, mesh) -> dict:
    """The logged scalars (0-d tensors) averaged over the data group: one
    all-reduce of them stacked."""
    if mesh is None:
        return logs
    flat = torch.stack([v.detach().reshape(()) for v in logs.values()])
    dist.all_reduce(flat, group=data_group(mesh))
    flat.div_(data_size(mesh))
    return dict(zip(logs, flat.unbind(0)))


class _GatherRows(torch.autograd.Function):
    """All ranks' ``x`` along ``dim`` as one tensor, differentiable: the
    forward sums zero-padded copies (exact, and an all-reduce runs under NCCL
    and under gloo, on CUDA tensors too), the backward sums every rank's
    gradient and keeps this rank's rows (the reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim: int, rank: int, size: int, group):
        ctx.dim, ctx.rank, ctx.n, ctx.group = dim, rank, x.shape[dim], group
        shape = list(x.shape)
        shape[dim] *= size
        full = x.new_zeros(shape)
        full.narrow(dim, rank * ctx.n, ctx.n).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None


def gather_batch(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every data rank's rows of ``x`` along ``dim``, in rank order: the global
    batch, on every rank, with the gradient of each rank's rows summed over
    the ranks in the backward. For a layer that mixes the rows of a batch
    (the stage-1 fusion and decoder attend across it), each rank runs it on
    the global batch and keeps its rows. ``x`` itself for ``mesh=None``."""
    if mesh is None or data_size(mesh) == 1:
        return x
    return _GatherRows.apply(x, dim, data_rank(mesh), data_size(mesh), data_group(mesh))


def gather_rows(x: np.ndarray, mesh) -> np.ndarray:
    """Every rank's ``x`` (the same shape on each), concatenated in rank order
    on every rank, over the host group. Needs a model axis of 1."""
    if mesh is None:
        return x
    if mesh.size(1) != 1:
        raise ValueError("host-side gathers need a mesh whose model axis is 1")
    t = torch.from_numpy(np.ascontiguousarray(x))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t, group=host_group())
    return torch.cat(parts).numpy()


def sharded_rows_fn(fn: Callable, mesh) -> Callable:
    """``fn`` ((N, ...) numpy rows -> numpy array, or dict of arrays, row by
    row) run over the data axis: the rows padded with zeros to a multiple of
    the axis, this rank's slice through ``fn``, the results gathered on every
    rank and the pad stripped (JAX: ``shard_map`` with ``P("data")`` in and
    out). ``fn`` itself for ``mesh=None``."""
    if mesh is None:
        return fn
    n_data = data_size(mesh)

    def run(rows: np.ndarray):
        rows = np.asarray(rows)
        n, pad = rows.shape[0], (-rows.shape[0]) % n_data
        if pad:
            rows = np.concatenate([rows, np.zeros((pad,) + rows.shape[1:], rows.dtype)])
        out = fn(shard_rows(rows, mesh))
        if isinstance(out, dict):
            return {k: gather_rows(np.asarray(v), mesh)[:n] for k, v in out.items()}
        return gather_rows(np.asarray(out), mesh)[:n]

    return run


class GradSync:
    """What a data-parallel train step needs of the mesh: this rank's rows of
    the global batch, the gradients' all-reduce, the logs' global means, and
    this rank's share of the dropout masks drawn for the global batch."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size, self.rank = data_size(mesh), data_rank(mesh)

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * size`` rows."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)

    def all_reduce(self, params: Iterable[torch.Tensor]) -> None:
        all_reduce_grads(params, self.mesh)

    def mean_logs(self, logs: dict) -> dict:
        return mean_logs(logs, self.mesh)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return gather_batch(x, self.mesh, dim)

    def dropout_draws(self, generator: Optional[torch.Generator]) -> tuple:
        """The step's ``generator`` as this rank's dropout draws
        ``(generator, world, rank)`` for ``models.transformer.dropout``: each
        mask drawn at the global batch's shape, this rank's rows kept (at
        world size 1, the masks a single process draws)."""
        return (generator, self.size, self.rank)
