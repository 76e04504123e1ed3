"""Multi-head attention of the AST ViT blocks: kernels K1 (forward) and K2 (backward).

``mha(q, k, v)`` on (B, H, S, D) tensors dispatches by the tensors' device:
a CUDA tensor launches the hand-written Hopper kernel
``csrc/attention_fwd.cu`` (which replaces the TPU kernel
``amuse_tpu/ops/attention.py::_attn_kernel``; its source note gives the
bound and the design), a CPU tensor runs ``mha_reference``. ``mha`` is
forward-only: on CUDA it refuses inputs that need a gradient (its output
would carry none) and points to ``mha_train``.

``mha_train(qkv)`` is the differentiable form the training path uses: a
``torch.autograd.Function`` whose forward launches K1 (which also writes the
row log-sum-exp) and whose backward launches K2, ``csrc/attention_bwd.cu``
(which replaces ``_attn_bwd_kernel``). It takes the fused (B, S, 3, H, D)
projection rather than q, k, v, so that K2 writes the gradient of the whole
projection as one contiguous tensor and the qkv Linear's backward needs no
``torch.cat`` of three gradients. On CPU tensors it is ``mha_reference``
with autograd through plain ops. ``mha_bwd`` is K2's wrapper and
``mha_bwd_reference`` its plain version.

There is no fallback: an unsupported CUDA input raises. ``mha.launches``
counts K1 launches (from ``mha`` and ``mha_train``), ``mha_bwd.launches``
K2 launches.
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


def mha_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 -> (dq, dk, dv), with the TPU kernel's rounding
    points (``amuse_tpu/ops/attention.py:153-185, 337-340``): P recomputed in
    float32, ``dS = P * (dP - rowsum(dP * P)) * scale``, dS and P cast to the
    operand type before the three products, each accumulated in float32 and
    cast to the input type. It needs neither K1's output nor its row
    log-sum-exp: P is recomputed from q and k."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    f32, dtype = torch.float32, q.dtype
    q, k, v, do = (t.to(dtype).to(f32) for t in (q, k, v, do))
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    ds_c, p_c = ds.to(dtype).to(f32), p.to(dtype).to(f32)
    dq = ds_c @ k
    dk = ds_c.transpose(-1, -2) @ q
    dv = p_c.transpose(-1, -2) @ do
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows for a bf16 kernel operand."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])


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
    if q.dtype == torch.bfloat16 and not all(_aligned(t) for t in (q, k, v)):
        raise ValueError("bfloat16 q, k, v need 16-byte aligned rows (pointers aligned to "
                         "16 bytes, batch/head/seq strides multiples of 8)")


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K1 on checked CUDA inputs -> (out, lse or None)."""
    b, h, s, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.load("attention_fwd")
    fn = lib.attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype],
            b, h, s, d, *strides, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "attention_fwd", rc)
    mha.launches += 1
    return out, lse


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D)) V on (B, H, S, D) -> (B, H, S, D), forward only.

    On CUDA the output is a (B, H, S, D) view of a (B, S, H, D) tensor, so
    ``out.transpose(1, 2).reshape(B, S, H * D)`` is free.
    """
    if q.device.type == "cpu":
        return mha_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on CUDA or CPU tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("mha is forward-only on CUDA and would drop the gradient of "
                           "q, k, v; use mha_train for a differentiable call")
    _check(q, k, v)
    return _launch_fwd(q, k, v, with_lse=False)[0]


mha.launches = 0


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor | None) -> torch.Tensor:
    """Attention backward -> dqkv (B, S, 3, H, D); ``dqkv[:, :, i].transpose(1, 2)``
    are dq, dk, dv.

    On CUDA it launches K2 (``o`` and ``lse`` are K1's output and row
    log-sum-exp); on the CPU it runs ``mha_bwd_reference`` (which needs
    neither).
    """
    b, h, s, d = q.shape
    dqkv = torch.empty((b, s, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
    if q.device.type == "cpu":
        for dst, src in zip((dq, dk, dv), mha_bwd_reference(q, k, v, do)):
            dst.copy_(src)
        return dqkv
    if q.device.type != "cuda":
        raise ValueError(f"mha_bwd runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v)
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or (q.dtype == torch.bfloat16 and not _aligned(do)):
        do = do.contiguous()
    if o.shape != q.shape or o.dtype != q.dtype or o.stride(-1) != 1 or do.shape != q.shape:
        raise ValueError("o and do must match q's shape and type with a contiguous head dim")
    if q.dtype == torch.bfloat16 and not _aligned(o):
        raise ValueError("bfloat16 o needs 16-byte aligned rows, as K1 writes it")
    if lse is None or lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be K1's float32 (B, H, S) contiguous log-sum-exp")
    # scratch of K2's first pass: per row the log-sum-exp and Delta = rowsum(dO * O),
    # the sequence padded to the 64-row tiles the other passes stream
    stats = torch.empty((b, h, 2, -(-s // 64) * 64), dtype=torch.float32, device=q.device)
    lib = _build.load("attention_bwd")
    fn = lib.attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
    strides = (ctypes.c_longlong * 24)(
        *(st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, s, d, strides, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "attention_bwd", rc)
    mha_bwd.launches += 1
    return dqkv


mha_bwd.launches = 0


def _split(qkv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, 3, H, D) -> strided (B, H, S, D) views q, k, v."""
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


class _MHATrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv):
        q, k, v = _split(qkv)
        _check(q, k, v)
        out, lse = _launch_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        return mha_bwd(*_split(qkv), out, do, lse)


def mha_train(qkv: torch.Tensor) -> torch.Tensor:
    """Differentiable attention over a fused (B, S, 3, H, D) projection -> (B, H, S, D).

    CUDA: K1 forward (with the row log-sum-exp) and K2 backward, whose
    gradient is one contiguous (B, S, 3, H, D) tensor. CPU: ``mha_reference``
    on the three views, with autograd through plain ops.
    """
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"mha_train takes a (B, S, 3, H, D) tensor, got {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return mha_reference(*_split(qkv))
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_train runs on CUDA or CPU tensors, got {qkv.device}")
    return _MHATrain.apply(qkv)
