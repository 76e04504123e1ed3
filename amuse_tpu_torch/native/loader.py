"""ctypes front end and ABIN writer of the native batch loader.

Port of ``amuse_tpu/native/loader.py`` over its own copy of the C++ source,
``amuse_io.cc``: an mmap'd ABIN file whose shuffled batches a prefetch
thread assembles into a ring of host buffers. ``build`` compiles it with
``g++`` at first use into ``build/amuse_tpu_torch/libamuse_io-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds).
A failed build raises: nothing falls back to the Python cache reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from amuse_tpu_torch.data.cache import FIELDS, WindowCache
from amuse_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "amuse_io.cc"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_DTYPES = {0: np.float32, 1: np.int32}
_DTYPE_IDS = {np.dtype(np.float32): 0, np.dtype(np.int32): 1}
_LOCK = threading.Lock()


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libamuse_io-{digest.hexdigest()[:12]}.so"


def build(src: Optional[Path] = None) -> Path:
    """The shared library of ``src`` (``SRC`` by default), compiled with g++
    if not yet built (about a second). Raises with the compiler's output
    when it fails."""
    src = SRC if src is None else Path(src)
    with _LOCK:
        out = _target(src)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            r = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                               capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native ABIN loader is built from "
                               f"{src.name} at first use") from e
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name} (rc {r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds each publish a whole file
        return out


def write_abin(path, records: dict[str, np.ndarray]) -> Path:
    """{name: (N, ...) array} -> one ABIN file (f32/i32 fields only).

    Written to a temporary file and renamed, so an interrupted write never
    leaves a truncated file where the loader (and train_gesture's
    mtime-gated reuse) would read it."""
    path = Path(path)
    names = list(records)
    n = records[names[0]].shape[0]
    arrays = {}
    for k in names:
        a = np.ascontiguousarray(records[k])
        if a.dtype not in _DTYPE_IDS:
            a = a.astype(np.float32 if np.issubdtype(a.dtype, np.floating) else np.int32)
        if a.shape[0] != n:
            raise ValueError(f"field {k} has {a.shape[0]} records, expected {n}")
        arrays[k] = a
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(b"ABIN")
        f.write(struct.pack("<IQ I", 1, n, len(names)))
        for k in names:
            a = arrays[k]
            kb = k.encode()
            f.write(struct.pack("<I", len(kb)))
            f.write(kb)
            f.write(struct.pack("<II", _DTYPE_IDS[a.dtype], a.ndim - 1))
            for d in a.shape[1:]:
                f.write(struct.pack("<Q", d))
        for i in range(n):
            for k in names:
                f.write(arrays[k][i].tobytes())
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(path)
    return path


def _bind(lib: ctypes.CDLL) -> None:
    for name, restype, argtypes in (
        ("amuse_open", ctypes.c_void_p, [ctypes.c_char_p]),
        ("amuse_num_records", ctypes.c_uint64, [ctypes.c_void_p]),
        ("amuse_num_fields", ctypes.c_uint32, [ctypes.c_void_p]),
        ("amuse_field_name", ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_uint32]),
        ("amuse_field_dtype", ctypes.c_uint32, [ctypes.c_void_p, ctypes.c_uint32]),
        ("amuse_field_ndim", ctypes.c_uint32, [ctypes.c_void_p, ctypes.c_uint32]),
        ("amuse_field_dim", ctypes.c_uint64, [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]),
        ("amuse_start_epoch", ctypes.c_uint64, [ctypes.c_void_p, ctypes.c_uint64,
                                                ctypes.c_uint64, ctypes.c_uint32,
                                                ctypes.c_uint32]),
        ("amuse_next_batch", ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p]),
        ("amuse_batch_bytes", ctypes.c_uint64, [ctypes.c_void_p]),
        ("amuse_close", None, [ctypes.c_void_p]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


class NativeWindowLoader:
    """Shuffled, prefetched epochs over an ABIN cache file.

    One epoch runs at a time: starting an epoch (or closing the loader)
    ends the generator of the previous one, which may live on another
    thread (a prefetch producer abandoned mid-epoch). The native calls go
    through one lock, so an epoch never restarts the ring while a batch is
    being copied out of it, and a stale generator yields nothing more.
    """

    def __init__(self, path):
        self._lib = ctypes.CDLL(str(build()))
        _bind(self._lib)
        L = self._lib
        self._lock = threading.Lock()
        self._epoch = 0  # the current epoch's token
        self._h = L.amuse_open(str(path).encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open ABIN cache: {path}")
        self.num_records = L.amuse_num_records(self._h)
        self.fields = []
        for i in range(L.amuse_num_fields(self._h)):
            shape = tuple(L.amuse_field_dim(self._h, i, d)
                          for d in range(L.amuse_field_ndim(self._h, i)))
            self.fields.append((L.amuse_field_name(self._h, i).decode(),
                                _DTYPES[L.amuse_field_dtype(self._h, i)], shape))

    def __len__(self):
        return int(self.num_records)

    def epoch(self, batch_size: int, seed: int = 0, shuffle: bool = True, prefetch: int = 3):
        """Yield {name: (B, ...) array} batches, assembled off-thread; the
        remainder is dropped."""
        with self._lock:
            if not self._h:
                raise ValueError("the loader is closed")
            self._epoch += 1
            token = self._epoch
            n_batches = self._lib.amuse_start_epoch(self._h, batch_size, seed, int(shuffle),
                                                    prefetch)
            buf = ctypes.create_string_buffer(self._lib.amuse_batch_bytes(self._h))
        for _ in range(n_batches):
            with self._lock:
                # a newer epoch or close() has taken the loader over
                if token != self._epoch or not self._lib.amuse_next_batch(self._h, buf):
                    return
            raw = np.frombuffer(buf, dtype=np.uint8)
            out, off = {}, 0
            for name, dtype, shape in self.fields:
                size = batch_size * int(np.prod(shape, dtype=np.int64)) * 4
                arr = raw[off:off + size].view(dtype).reshape((batch_size,) + shape)
                # a copy: the buffer is refilled for the next batch, while a
                # prefetched batch may still wait for its pinned copy
                out[name] = arr.copy()
                off += size
            yield out

    def close(self):
        if getattr(self, "_h", None):
            with self._lock:
                self._epoch += 1
                self._lib.amuse_close(self._h)
                self._h = None

    def __del__(self):
        self.close()


def cache_to_abin(cache_dir, out_path, fields: Optional[Sequence[str]] = None) -> Path:
    """A sharded ``WindowCache`` -> one ABIN file of ``fields`` (all by
    default; the train loop leaves out the 640 KB audio column)."""
    fields = list(fields) if fields else list(FIELDS)
    wc = WindowCache(cache_dir)
    items = [wc[i] for i in range(len(wc))]
    stacked = {f: np.stack([it[f] for it in items]) for f in fields}
    for k in ("actor_id", "emo_label"):
        if k in stacked:
            stacked[k] = stacked[k].astype(np.int32)
    return write_abin(out_path, stacked)
