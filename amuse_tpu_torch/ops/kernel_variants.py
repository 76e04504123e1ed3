"""The fused-attention kernel variants V1-V5 of ``benchmarks/kernel_variants.py``.

The JAX file times five Pallas variants of the AST attention against the
fused K1+K2 pair, at (B, H, S, D) = (4, 12, 1214, 64) bf16, in a 12-call
forward+backward chain. Here each variant is ``make_variant(name) ->
mha(q, k, v)``, a ``torch.autograd.Function`` over two wrappers:

  * ``variant_fwd(q, k, v, body)`` -> o, the forward of body "softmax" (the
    TPU bodies ``_fwd_kernel_v1``, ``_v3``, ``_v4``, which compute one
    function) or "dots" (``_fwd_kernel_v0``). A CUDA tensor launches
    ``csrc/attention_variants_fwd.cu``, which replaces the TPU kernels V1
    ``_call_fwd`` (``benchmarks/kernel_variants.py:120``), V3
    ``_call_fwd_v3`` (:373) and V5 ``make_v5.call_fwd`` (:441): the three
    differ only in the TPU grid.
  * ``variant_bwd(q, k, v, do, body)`` -> (dq, dk, dv), the backward of body
    "v1" (``_bwd_kernel_v1`` and ``_v3``: every product in float32), "v4"
    (``_bwd_kernel_v4``: dS and P/r rounded to bf16) or "v0"
    (``_bwd_kernel_v0``). A CUDA tensor launches
    ``csrc/attention_variants_bwd.cu``, which replaces V2 ``_call_bwd``
    (:143) and V4 ``_call_bwd_v3`` (:393): bf16 inputs go to its wgmma
    kernels (v1 and v0 multiply their float32 operands in three exact bf16
    pieces), float32 inputs to its FMA kernels.

A CPU tensor runs the plain versions ``variant_fwd_reference`` and
``variant_bwd_reference``, which follow each TPU body's rounding points;
nothing on the card's path calls them. There is no fallback: a CUDA input
the kernels do not take raises, and so does a head dim other than 64 (the
JAX file's ``D``). ``variant_fwd.launches`` and ``variant_bwd.launches``
count kernel launches, ``variant_bwd.routes`` the backward's by the kernels
they went to (``BWD_ROUTES``).

    python -m amuse_tpu_torch.ops.kernel_variants [--iters 20] [--device cuda]

is the counterpart of the JAX file's ``main``: parity of V1, V3, V4 and V5
against ``ops.attention.mha_reference`` (values and gradients), then the
chain's ms of the K1+K2 baseline and of each variant, one JSON line per leg.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess

import numpy as np
import torch

from amuse_tpu_torch.ops import _build

B, H, S, D = 4, 12, 1214, 64
SCALE = 1.0 / math.sqrt(D)
CHAIN_CALLS = 12

FWD_BODIES = {"softmax": 0, "dots": 1}
BWD_BODIES = {"v1": 0, "v4": 1, "v0": 2}
# the kernels a variant_bwd launch went to, as the C entry point reports it:
# the float32 FMA kernels (float32 inputs) or the bf16 wgmma kernels
BWD_ROUTES = ("fma", "wgmma")
# variant name -> (forward body, backward body), as the JAX file builds them
VARIANTS = {
    "v1_divfold": ("softmax", "v1"),    # make_variant(_fwd_kernel_v1, _bwd_kernel_v1)
    "v0_dotsonly": ("dots", "v0"),      # make_variant(_fwd_kernel_v0, _bwd_kernel_v0)
    "v3_headloop": ("softmax", "v1"),   # make_v3(): v1's bodies over two heads a program
    "v4_bf16dots": ("softmax", "v4"),   # make_variant(_fwd_kernel_v4, _bwd_kernel_v4)
    "v5_fullq_fwd": ("softmax", "v4"),  # make_v5(): v4's forward over the whole S
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32

# What a kernel on the card must meet against its plain version on the same
# inputs (chip_smoke.py and the GPU tests): max |kernel - plain| <=
# kernel_limit(...) per output. The softmax, dots, v1 and v0 bodies: 1e-4 of
# the largest plain value for a float32 output (summation order); one bf16
# ulp at the largest plain value for a bf16 one, 2^(floor(log2 max) - 7),
# between 2^-8 and 2^-7 of it (a float32 sum taken in another order rounds
# to the neighbouring bf16 value, which at an entry in the largest value's
# binade is more than 2^-8 of the largest). The v4 backward at either input
# type: 2e-2 of the largest entry and relative L2 8e-3 per gradient, as for
# K2 (dS and P/r rounded to bf16 from float32 values that differ in the last
# bits). A bf16 forward must also equal its plain version bit for bit on at
# least KERNEL_BIT_EQUAL_SHARE of its entries: e rounded against the row's
# final maximum (the dots: s rounded once), as the TPU bodies do. A design
# that rounds e elsewhere meets the error limit and falls short of the
# share (K1's online softmax; PERF.md).
KERNEL_F32_REL = 1e-4
KERNEL_V4_REL, KERNEL_V4_REL_L2 = 2e-2, 8e-3
KERNEL_BIT_EQUAL_SHARE = 0.99


def kernel_limit(dtype: torch.dtype, body: str, top: float) -> float:
    """The largest |kernel - plain| allowed for an output of ``dtype`` whose
    largest plain entry is ``top``."""
    if body == "v4":
        return KERNEL_V4_REL * top
    if dtype == _F32:
        return KERNEL_F32_REL * top
    return math.ldexp(1.0, math.frexp(top)[1] - 8)  # top = m 2^e, m in [0.5, 1)


# Inputs on which a float32 operand multiplied in fewer than three bf16
# pieces breaks kernel_limit at bf16: each case makes one gradient (two for
# "small_scores") a small difference of large products, from rows in pairs
# (2t, 2t + 1) whose terms nearly cancel, so a piece's rounding (2^-17 of the
# operand for two pieces) is no longer small against the result. The pairs
# differ by w e_0, w ~ CANCELLATION_DELTA N(0, 1), put where the first row's
# column 0 is zero, so that both rows are exact in bf16:
#   "keys": k_{2t+1} = -k_{2t}, v_{2t+1} = v_{2t} + w e_0: dq (v0);
#   "queries": q_{2t+1} = q_{2t}, dO_{2t+1} = -dO_{2t} + w e_0: dk;
#   "values": q_{2t+1} = q_{2t} + w e_0, dO_{2t+1} = -dO_{2t}: dv;
#   "small_scores" (v1): q ~ CANCELLATION_SMALL_Q in opposite pairs, k in
#   opposite pairs, v and dO in equal pairs: e of a pair differs by about
#   2 |s|, which dq and dk keep.
# The sizes leave the gradients' float32 rounding (summed in any order) well
# inside the limit (tests/test_torch_port_gpu.py holds a float64 model of the
# two splits to it); a case that made a gradient vanish would hold its
# rounding alone to the limit and is not used (v0's dq in "small_scores").
CANCELLATION_SHAPE = (2, 4, 128, 64)  # S even: rows pair up
CANCELLATION_DELTA, CANCELLATION_SMALL_Q = 2.0 ** -11, 2.0 ** -13.5
CANCELLATION_CASES = {"v1": ("small_scores", "queries", "values"),
                      "v0": ("keys", "queries", "values")}
# the gradients each case makes small differences
CANCELLATION_TARGETS = {"keys": ("dq",), "queries": ("dk",), "values": ("dv",),
                        "small_scores": ("dq", "dk")}


def cancellation_inputs(case: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """q, k, v, dO (bf16, on the CPU, CANCELLATION_SHAPE) of a cancellation
    case (a key of ``CANCELLATION_TARGETS``), from numpy's generator seeded
    with 0."""
    b, h, s, d = CANCELLATION_SHAPE
    rng = np.random.default_rng(0)

    def rows(scale: float, sign: float = 0.0, delta: float = 0.0) -> torch.Tensor:
        x = rng.normal(size=(b, h, s, d)) * scale
        if sign:
            x[:, :, 1::2] = sign * x[:, :, 0::2]
        if delta:
            x[:, :, 0::2, 0] = 0.0
            x[:, :, 1::2, 0] = rng.normal(size=(b, h, s // 2)) * delta
        return torch.from_numpy(x).to(torch.bfloat16)

    w = CANCELLATION_DELTA
    if case == "keys":
        return rows(0.5), rows(1.0, -1.0), rows(1.0, 1.0, w), rows(1.0)
    if case == "queries":
        return rows(0.5, 1.0), rows(1.0), rows(1.0), rows(1.0, -1.0, w)
    if case == "values":
        return rows(0.5, 1.0, w), rows(1.0), rows(1.0), rows(1.0, -1.0)
    if case == "small_scores":
        return (rows(CANCELLATION_SMALL_Q, -1.0), rows(1.0, -1.0), rows(1.0, 1.0),
                rows(1.0, 1.0))
    raise ValueError(f"cancellation case {case!r} is not one of {sorted(CANCELLATION_TARGETS)}")


def bit_equal_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of entries where ``a`` and ``b`` are the same value."""
    return (a == b).float().mean().item()


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """s = (q k^T) * scale in float32 (bf16 products are exact in float32)."""
    return (q.to(_F32) @ k.to(_F32).transpose(-1, -2)) * SCALE


def _softmax_parts(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """e = exp(s - rowmax(s)) against the row's final maximum, r = rowsum(e).
    Keys past S, which the TPU masks to float32's minimum, give exp(...) = 0
    there and are simply absent here."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True)


def variant_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          body: str) -> torch.Tensor:
    """Plain forward of body "softmax" (``_fwd_kernel_v1/_v3/_v4``: e rounded
    once to v's type, e v accumulated in float32, divided by r, cast to q's
    type) or "dots" (``_fwd_kernel_v0``: (s cast to v's type) v, no softmax)."""
    s = _scores(q, k)
    if body == "dots":
        return (s.to(v.dtype).to(_F32) @ v.to(_F32)).to(q.dtype)
    if body != "softmax":
        raise ValueError(f"forward body {body!r} is not one of {sorted(FWD_BODIES)}")
    e, r = _softmax_parts(s)
    return ((e.to(v.dtype).to(_F32) @ v.to(_F32)) / r).to(q.dtype)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(_F32)


def variant_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, body: str
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward -> (dq, dk, dv) in q's, k's and v's types, from q, k, v
    and dO alone (no saved output or log-sum-exp), at the rounding points of

      * "v1" (``_bwd_kernel_v1``, ``_v3``): all float32; don = dO / r,
        dp = don v^T, ds = e (dp - rowsum(dp e) / r) scale, dq = ds k,
        dk = ds^T q, dv = e^T don;
      * "v4" (``_bwd_kernel_v4``): dp = dO v^T, ds = e (dp - rowsum(dp e) / r)
        / r scale rounded to bf16, dq = ds16 k, dk = ds16^T q,
        dv = bf16(e / r)^T dO, whatever the input type;
      * "v0" (``_bwd_kernel_v0``): s = q k^T scale, ds = dO v^T scale,
        dq = ds k, dk = ds^T q, dv = s^T dO.
    """
    if body not in BWD_BODIES:
        raise ValueError(f"backward body {body!r} is not one of {sorted(BWD_BODIES)}")
    qf, kf, vf, dof = (t.to(_F32) for t in (q, k, v, do))
    s = _scores(q, k)
    if body == "v0":
        ds = (dof @ vf.transpose(-1, -2)) * SCALE
        p, x = s, dof
    else:
        e, r = _softmax_parts(s)
        if body == "v1":
            x = dof / r
            dp = x @ vf.transpose(-1, -2)
            ds = e * (dp - (dp * e).sum(-1, keepdim=True) / r) * SCALE
            p = e
        else:
            x = dof
            dp = dof @ vf.transpose(-1, -2)
            ds = _bf16(e * (dp - (dp * e).sum(-1, keepdim=True) / r) / r * SCALE)
            p = _bf16(e / r)
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ x
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(*ts: torch.Tensor) -> None:
    q = ts[0]
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v (and dO) must lie on one device")
    if q.ndim != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"q, k, v (and dO) must share one (B, H, S, D) shape; got "
                         f"{[tuple(t.shape) for t in ts]}")
    if q.shape[-1] != D:
        raise ValueError(f"head dim {q.shape[-1]} not supported (the variants take D = {D})")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q, k, v (and dO) must all be float32 or bfloat16; got "
                         f"{[t.dtype for t in ts]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the variants run on CUDA or CPU tensors, got {q.device}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it: contiguous, 16-byte aligned (a copy where
    it is not)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def variant_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, body: str) -> torch.Tensor:
    """Forward of ``body`` on (B, H, S, 64) q, k, v -> (B, H, S, 64) in q's
    type. CUDA: one launch of ``csrc/attention_variants_fwd.cu``; CPU:
    ``variant_fwd_reference``."""
    if body not in FWD_BODIES:
        raise ValueError(f"forward body {body!r} is not one of {sorted(FWD_BODIES)}")
    _check(q, k, v)
    if q.device.type == "cpu":
        return variant_fwd_reference(q, k, v, body)
    q, k, v = (_dense(t) for t in (q, k, v))
    b, h, s, _ = q.shape
    out = torch.empty_like(q)
    lib = _build.load("attention_variants_fwd")
    fn = lib.variant_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
            FWD_BODIES[body], b, h, s, SCALE, _stream(q))
    _build.check(lib, "variant_fwd", rc)
    variant_fwd.launches += 1
    return out


variant_fwd.launches = 0


def variant_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                body: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``body`` -> (dq, dk, dv) in the inputs' type. CUDA: one
    launch of ``csrc/attention_variants_bwd.cu`` (its passes on one stream);
    CPU: ``variant_bwd_reference``."""
    if body not in BWD_BODIES:
        raise ValueError(f"backward body {body!r} is not one of {sorted(BWD_BODIES)}")
    _check(q, k, v, do)
    if q.device.type == "cpu":
        return variant_bwd_reference(q, k, v, do, body)
    q, k, v, do = (_dense(t) for t in (q, k, v, do))
    b, h, s, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per row m (bf16 v4: m log2(e)), r (bf16 v4: 1/r) and rowsum(dp e) / r, padded to 64 rows
    stats = torch.empty((b * h, 3, -(-s // 64) * 64), dtype=_F32, device=q.device)
    lib = _build.load("attention_variants_bwd")
    fn = lib.variant_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    route = ctypes.c_int(-1)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype],
            BWD_BODIES[body], b, h, s, SCALE, _stream(q), ctypes.byref(route))
    _build.check(lib, "variant_bwd", rc)
    variant_bwd.launches += 1
    variant_bwd.routes[BWD_ROUTES[route.value]] += 1
    return dq, dk, dv


variant_bwd.launches = 0
variant_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)


class _Variant(torch.autograd.Function):
    """One variant's custom VJP: the forward saves q, k, v (as the JAX
    ``custom_vjp`` does) and the backward recomputes everything from them."""

    FWD = BWD = ""

    @classmethod
    def forward(cls, ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return variant_fwd(q, k, v, cls.FWD)

    @classmethod
    def backward(cls, ctx, do):
        q, k, v = ctx.saved_tensors
        return variant_bwd(q, k, v, do.to(q.dtype), cls.BWD)


_FUNCTIONS = {name: type(f"Variant_{name}", (_Variant,), {"FWD": fwd, "BWD": bwd})
              for name, (fwd, bwd) in VARIANTS.items()}


def make_variant(name: str):
    """``mha(q, k, v)`` of the named variant (a key of ``VARIANTS``)."""
    fn = _FUNCTIONS[name]

    def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return fn.apply(q, k, v)

    mha.__name__ = name
    return mha


def baseline_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fused K1+K2 pair of the AST blocks (``ops.attention.mha_train``) on
    separate q, k, v: stacked into the (B, S, 3, H, D) projection it takes."""
    from amuse_tpu_torch.ops.attention import mha_train

    return mha_train(torch.stack((q, k, v), dim=1).permute(0, 3, 1, 2, 4))


def chain(attn):
    """value_and_grad of the 12-call loss of the JAX file (lines 477-487):
    q_0 = x, q_{i+1} = attn(q_i, x, x), loss = sum_i sum(q_{i+1}^2) in float32.
    -> fn(x) -> (loss, dloss/dx)."""

    def value_and_grad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.detach().requires_grad_()
        q, acc = x, torch.zeros((), dtype=_F32, device=x.device)
        for _ in range(CHAIN_CALLS):
            o = attn(q, x, x)
            acc = acc + o.to(_F32).square().sum()
            q = o
        (grad,) = torch.autograd.grad(acc, x)
        return acc.detach(), grad

    return value_and_grad


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of fn() over ``iters`` calls, on CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _card(device: torch.device) -> dict:
    """The timed card's name, and its name and power limit as nvidia-smi
    gives them (its row of the listing, which follows CUDA's order only where
    CUDA_VISIBLE_DEVICES and CUDA_DEVICE_ORDER leave it so)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"device": torch.cuda.get_device_name(index), "nvidia_smi": smi}


def main(argv=None) -> list[dict]:
    """Print (and return) one JSON line for the card, one per parity check
    and one per chain leg, each as it ends."""
    ap = argparse.ArgumentParser(description="Parity and chain times of the attention "
                                             "kernel variants V1-V5 on the card.")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"kernel_variants times the CUDA kernels and needs a CUDA card "
                           f"(device {args.device!r}, cuda available: "
                           f"{torch.cuda.is_available()})")
    from amuse_tpu_torch.ops.attention import mha_reference

    rows = []

    def emit(row: dict) -> None:
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit(_card(device))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, H, S, D)) * 0.05).to(device, torch.bfloat16)

    def grad_of(attn):
        q = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(attn(q, x, x).to(_F32).square().sum(), q)
        return g.to(_F32)

    def dev(a, b) -> float:
        return (a.to(_F32) - b.to(_F32)).abs().max().item()

    ref_out, g_ref = mha_reference(x, x, x), grad_of(mha_reference)
    variants = {name: make_variant(name) for name in VARIANTS}
    for tag, name in (("v1", "v1_divfold"), ("v3", "v3_headloop"), ("v4", "v4_bf16dots")):
        row = {f"{tag}_out_dev": dev(ref_out, variants[name](x, x, x)),
               f"{tag}_grad_dev": dev(g_ref, grad_of(variants[name]))}
        if tag == "v4":
            row["grad_scale"] = g_ref.abs().max().item()
        emit(row)
    legs = {"baseline": baseline_mha, **variants}
    for name, attn in legs.items():
        row = {"leg": name, "ms": cuda_ms(lambda: chain(attn)(x), args.iters),
               "shape": [B, H, S, D], "dtype": "bfloat16", "calls": CHAIN_CALLS}
        if name == "v5_fullq_fwd":
            row["v5_out_dev"] = dev(ref_out, attn(x, x, x))
        emit(row)
    return rows


if __name__ == "__main__":
    main()
