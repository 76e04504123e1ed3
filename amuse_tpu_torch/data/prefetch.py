"""Host->device prefetching: overlap batch assembly and the copy with device work.

Port of ``amuse_tpu/data/prefetch.py``. ``prefetch_to_device`` wraps a
batch iterator with a background thread that keeps ``size`` batches ahead of
the consumer. On CUDA each batch is copied from pinned host memory on a side
stream; the consumer's stream waits for that copy before the batch is
handed out, and each tensor is recorded as used by the consumer's stream,
so the allocator does not reuse its memory while the consumer's kernels
may still read it. On the CPU the thread only turns arrays into tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from amuse_tpu_torch.parallel.mesh import shard_rows


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: str | torch.device = "cuda", mesh=None) -> Iterator[dict]:
    """Yield batches (dicts of arrays) as dicts of tensors on ``device``,
    ``size`` ahead of the consumer, in order. With a ``mesh`` each batch is a
    global batch and only this rank's rows of it are copied
    (``parallel.mesh.shard_rows``).

    An error of ``iterator`` is raised in the consumer. Abandonment-safe: if
    the consumer drops the generator mid-epoch, closing it sets a stop
    event; the producer's queue puts time out and re-check it, so the
    thread exits instead of waiting forever with batches on the device.
    """
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def transfer(batch: dict):
        batch = shard_rows(batch, mesh)
        host = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        if not on_cuda:
            return host, None
        with torch.cuda.stream(copy_stream):
            out = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                put(transfer(batch))
        except BaseException as e:  # surfaced in the consumer thread
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for v in batch.values():
                    v.record_stream(stream)
            yield batch
    finally:
        stop.set()  # runs on generator close/GC too (GeneratorExit)
