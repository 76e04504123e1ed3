"""Forward multi-head attention of the AST ViT blocks: kernel K1 and its plain version.

``mha(q, k, v)`` on (B, H, S, D) tensors dispatches by the tensors' device:
a CUDA tensor launches the hand-written Hopper kernel
``csrc/attention_fwd.cu`` (which replaces the TPU kernel
``amuse_tpu/ops/attention.py::_attn_kernel``; its source note gives the
bound and the design), a CPU tensor runs ``mha_reference``. There is no
fallback: an unsupported CUDA input raises. ``mha.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from amuse_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with the kernel's semantics: scores and softmax in
    float32, P cast to V's type before P V."""
    d = q.shape[-1]
    s = q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)
    p = torch.softmax(s / math.sqrt(d), dim=-1)
    return (p.to(v.dtype) @ v).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.ndim != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q, k, v must all be float32 or bfloat16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not supported (kernel takes {HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(
        t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)
    ):
        raise ValueError("bfloat16 q, k, v need 16-byte aligned rows (pointers aligned to "
                         "16 bytes, batch/head/seq strides multiples of 8)")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("B * H must be at most 65535")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D)) V on (B, H, S, D) -> (B, H, S, D).

    On CUDA the output is a (B, H, S, D) view of a (B, S, H, D) tensor, so
    ``out.transpose(1, 2).reshape(B, S, H * D)`` is free.
    """
    if q.device.type == "cpu":
        return mha_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.load("attention_fwd")
    fn = lib.attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
            b, h, s, d, *strides, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "attention_fwd", rc)
    mha.launches += 1
    return out


mha.launches = 0
