"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/amuse_tpu_torch/lib<name>-<hash>.so`` (the hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source rebuilds) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

Each source exports plain C functions (pointers and the stream as
``void*``) that return ``cudaGetLastError()`` after the launch; the Python
wrappers raise when it is not 0. Only the repository's own sources are
built. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "amuse_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "amuse_tpu_torch are built from source at first use"
    )


def sources() -> list[str]:
    """Names of the kernel sources under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named sources (all by default), one nvcc each, all in parallel.

    Returns ``{name: {"seconds": s, "log": nvcc/ptxas output}}`` for the
    sources compiled by this call (already-built ones are skipped). Raises
    with the compiler's output when any build fails.
    """
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    results, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build([name])
            lib = ctypes.CDLL(str(out))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, what: str, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
