"""Residual add + LayerNorm of the AST's ViT blocks, forward only.

``add_layer_norm(x, delta, weight, bias, eps)`` on x and delta (G, ..., E)
with per-encoder (G, E) weight and bias returns ``(s, h)``: ``s = x + delta``
in x's dtype and ``h`` the LayerNorm of s over E (statistics and affine in
float32, one rounding to x's dtype); with ``delta`` None it returns ``h``
of x alone. It dispatches by the tensors' device: a CUDA tensor launches
the hand-written kernel ``csrc/add_layer_norm.cu`` (one pass, its source
note gives the bound and the design), a CPU tensor runs
``add_layer_norm_reference``. Forward only: on CUDA it refuses inputs that
need a gradient; the differentiated path keeps the plain add and
``layer_norm_reference``.

It takes float32 and bfloat16 (all four tensors of one dtype) with E a
multiple of 8 up to 1024, on both devices; on CUDA the tensors must also be
contiguous and 16-byte aligned. There is no fallback: anything else raises.
``add_layer_norm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch
import torch.nn.functional as F

from amuse_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1024


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """Per-encoder LayerNorm over the last dim of x (G, ..., E) with (G, E)
    weight and bias: statistics and affine in float32, cast to x's dtype."""
    shape = (weight.shape[0],) + (1,) * (x.ndim - 2) + (weight.shape[-1],)
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return (y * weight.view(shape).float() + bias.view(shape).float()).to(x.dtype)


def add_layer_norm_reference(x: torch.Tensor, delta: Optional[torch.Tensor],
                             weight: torch.Tensor, bias: torch.Tensor, eps: float
                             ) -> Union[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Plain version of the kernel: ``x + delta`` in x's dtype, then
    ``layer_norm_reference`` -> (s, h); h alone when delta is None."""
    if delta is None:
        return layer_norm_reference(x, weight, bias, eps)
    s = x + delta
    return s, layer_norm_reference(s, weight, bias, eps)


def _check(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
           bias: torch.Tensor) -> None:
    tensors = [t for t in (x, delta, weight, bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, delta, weight and bias must lie on one device")
    if x.ndim < 2:
        raise ValueError(f"x must be (G, ..., E); got shape {tuple(x.shape)}")
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"delta must have x's shape {tuple(x.shape)}; got {tuple(delta.shape)}")
    g, e = x.shape[0], x.shape[-1]
    if weight.shape != (g, e) or bias.shape != (g, e):
        raise ValueError(f"weight and bias must be (G, E) = ({g}, {e}), one row per encoder of "
                         f"x's leading axis G; got {tuple(weight.shape)}, {tuple(bias.shape)}")
    if any(t.dtype != x.dtype for t in tensors) or x.dtype not in _DTYPE_CODE:
        raise ValueError("x, delta, weight and bias must all be float32 or bfloat16; got "
                         + ", ".join(str(t.dtype) for t in tensors))
    if e % 8 or e > MAX_WIDTH:
        raise ValueError(f"width E = {e} not supported (the kernel takes multiples of 8 up to "
                         f"{MAX_WIDTH})")


def add_layer_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, eps: float
                   ) -> Union[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """(s = x + delta, h = LayerNorm(s)) on x (G, ..., E); h alone when delta is None."""
    _check(x, delta, weight, bias)
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, delta, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm runs on CUDA or CPU tensors, got {x.device}")
    tensors = [t for t in (x, delta, weight, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("add_layer_norm is forward-only on CUDA and would drop the gradient "
                           "of its inputs; differentiate x + delta and layer_norm_reference")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("x, delta, weight and bias must be contiguous with 16-byte aligned "
                         "pointers on CUDA")
    h = torch.empty_like(x)
    s = None if delta is None else torch.empty_like(x)
    lib = _build.load("add_layer_norm")
    fn = lib.add_layer_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = fn(x.data_ptr(), None if delta is None else delta.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), None if s is None else s.data_ptr(), h.data_ptr(),
            _DTYPE_CODE[x.dtype], x.numel() // x.shape[-1], x.shape[0], x.shape[-1], eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "add_layer_norm", rc)
    add_layer_norm.launches += 1
    return h if s is None else (s, h)


add_layer_norm.launches = 0
