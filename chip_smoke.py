#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card
    python3 chip_smoke.py --only-k1  # build, then the K1 phase alone
    python3 chip_smoke.py --only-k2  # build, then the K2 phase alone
    python3 chip_smoke.py --only-k3  # build, then K3 timed at N = 1, 4, 8 and 32 alone
    python3 chip_smoke.py --only-wav-to-motion  # build, then wav_to_motion at N = 1 and 4 alone
    python3 chip_smoke.py --only-train-step  # build, then the flagship train step alone
    python3 chip_smoke.py --only-train-step --train-steps 12  # with 12 timed steps, not 4
    python3 chip_smoke.py --only-edit  # build, then checkpoint_load and edit_gesture alone
    python3 chip_smoke.py --only-prepare-data  # build, then prepare_data alone
    python3 chip_smoke.py --only-train-gesture  # build, then the three LPDM phases alone
    python3 chip_smoke.py --only-eval  # build, then eval_gesture, train_embedder, native loader
    python3 chip_smoke.py --only-host-tasks  # build, then bvh2smplx_, render tasks, blender_setup
    python3 chip_smoke.py --only-legacy  # build, then the legacy zoo and MFCC + DTW alone
    python3 chip_smoke.py --only-distributed  # build, then the data-parallel phases alone
    python3 chip_smoke.py --only-orbax  # build, then a converted JAX train state resumed
    python3 chip_smoke.py --only-kernel-variants  # build, then the attention variants V1-V5

Builds the port's CUDA kernels from ``amuse_tpu_torch/csrc`` (one nvcc per
source, in parallel), holds each kernel against its plain PyTorch version at
the shapes the main paths give it, drives the two main paths and checks by
the kernels' launch counters that each went through its kernels:

  * inference: ``GesturePipeline.wav_to_motion`` at the flagship widths with
    random weights, then the ``infer_gesture`` CLI (K1, K3);
  * stage-1 training: the ``train_audio`` step at small widths against the
    CPU plain path, at the flagship widths (timed, traced), then the
    ``train_audio`` CLI with a checkpoint and a resume (K1, K2);
  * editing: a released checkpoint directory at the flagship widths loaded
    by ``utils/checkpoint_io.py``, then ``emotion_control`` and
    ``style_transfer`` through it (K1, K3);
  * ``prepare_data``: the frozen-AST stage-2 cache and the stage-1 quads
    (K1), then the ``edit_gesture`` and ``prepare_data`` CLIs at tiny widths
    on the card against the CPU;
  * stage-2 training: the ``train_gesture`` step at small widths against the
    CPU plain path (K3 over freshly packed weights, prefetch), at the
    flagship widths with the DDIM monitor every step (timed, traced), then
    the ``train_gesture`` CLI with a checkpoint and a resume (K3);
  * resuming a JAX run: train states in the JAX package's orbax layout
    (random weights and moments) mapped by ``convert.py`` and resumed, the
    flagship LPDM step (K3) and the small stage-1 step (K1, K2) on the card
    against the CPU, the flagship stage-1 mapping timed and its resumed
    step (K1, K2);
  * evaluation: ``evaluate_cache`` over 100 windows at the flagship widths
    (K3 once per batch of 32, the tail of 4 included) against its small-width
    run on the CPU; the external embedder's train step; the native ABIN
    loader through the pinned prefetch, and ``train_gesture`` fed by it;
  * the host-side tasks: ``bvh2smplx_`` over a 60 s and a 10 min take on the
    card against the CPU, ``render_gt``/``render_baselines`` trees card
    against CPU, ``mux_audio``/``concat_grid`` on real ffmpeg where it is
    installed, ``blender_setup`` without Blender, and ``infer_gesture`` at
    the flagship widths with its render wiring (recording stubs named
    ``blender`` and ``ffmpeg``; K1, K3);
  * the legacy zoo and MFCC + DTW: every member's forward and three
    raw-diffusion train steps, both samplers, MFCC and DTW at small widths
    on the card against the CPU; the raw-diffusion train step (batch 32),
    its ancestral and DDIM samplers, MFCC over 32 clips of 10 s, DTW of a
    10 s pair, and one forward of each member at its default widths (no
    kernel of the port: the K1, K2 and K3 counters stay at 0);
  * data parallelism (``parallel/mesh.py``; the machine has one card): NCCL
    at world size 1 in this process, the flagship stage-1 and LPDM steps
    with and without the gradient sync (the sync the identity bit for bit,
    its all-reduce timed; K1, K2, K3 counted), two gloo ranks sharing the
    card against one process (the small LPDM and stage-1 steps, the sharded
    fbank and ``encode_audio``), and the ``train_gesture`` CLI launched at
    world size 1 through ``cluster/jobs.py`` against a plain run;
  * the attention kernel variants V1-V5 of ``benchmarks/kernel_variants.py``
    (``ops/kernel_variants.py``): each body's forward and backward kernel
    against its plain version at a small float32 shape and at the harness's
    (4, 12, 1214, 64) bf16, timed beside SDPA; the entry point
    ``kernel_variants.main`` (parity, the 12-call chains of the K1+K2
    baseline and of each variant, timed), and one chain of each variant
    counted (12 forward and 12 backward launches, no K1, K2 or K3).

Each phase prints one JSON line as it ends; after the ``{"kernels": [...]}``
line and the card's ``name, power.limit`` line, the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero. Without CUDA, or outside a checkout,
it exits non-zero before printing any result. Imports no JAX. Logs go to
``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM published dense peaks (NVIDIA's data sheet, 700 W): bf16 tensor
# cores, float32 outside the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

K1_TOL = 3e-2  # bf16 output, P rounded to bf16 at different points (tests/test_ops.py:41-43)
K1_TOL_F32 = 2e-5
# At the AST length the outputs of random inputs are small (rms ~ 0.05), so
# K1_TOL there is the size of a typical value and 8-15 times the readings.
# Three more limits hold K1: the largest error of the bf16 AST cases
# (K1_TOL_AST, two bf16 ulps of an output in [0.5, 1)), the relative L2
# error of the whole output (K1_REL_L2), and the row log-sum-exp of the
# instantiation that writes it against torch.logsumexp (K1_LSE_TOL, plus 1e-5
# of the value), whose output must equal the other's bit for bit.
K1_TOL_AST = 8e-3
K1_REL_L2 = {"float32": 1e-5, "bfloat16": 6e-3}  # readings on an H100: 2.6e-7, 3.1e-3
K1_LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
# K3 against the plain loop, float32: one step (tests/test_denoiser_kernel.py:68);
# 50 steps at the flagship dims, 4.6 times the largest reading on an H100
# (1.7e-5 to 4.3e-5), below a plain loop whose products run in TF32 (its
# reading is printed beside it); 50 steps at the small widths, where the
# readings reach 3.3e-4 (tests/test_denoiser_kernel.py:47)
K3_TOL_STEP = 2e-4
K3_TOL = 2e-4
K3_TOL_SMALL = 2e-3
PIPE_TOL = 1e-3  # small-width pipeline, kernels vs plain, float32
# K2: max |kernel - plain| <= rel * max |plain|, per gradient. float32:
# summation order and Delta = rowsum(dO * O) in place of rowsum(dP * P);
# bf16: one or two bf16 ulps of the outputs (dS rounded to bf16 from float32
# values that differ in the last bits, O rounded to bf16 inside Delta).
K2_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# and each gradient's relative L2 error (readings on an H100: 3.1e-7, 3.2e-3)
K2_REL_L2 = {"float32": 1e-5, "bfloat16": 8e-3}
TRAIN_LOSS_RTOL = 1e-4  # small-width train step, card vs CPU, float32
TRAIN_GRAD_REL = 1e-3  # per parameter, of its largest gradient entry
TRAIN_LR = 1e-4  # parameters after two steps: atol TRAIN_LR / 10
# small-width train step in bf16, card vs CPU: the loss, and all gradients
# of step 1 together (relative L2); about twice the readings on an H100
# (2.1e-4 and 5.5e-3, where bf16 itself moves the CPU's loss by 6.3e-4 and
# its gradients by 6.1e-3 from float32, printed beside them). Two bf16
# programs that round at different points (K1/K2 against autograd through
# the plain attention, cuBLAS against CPU GEMMs) differ by bf16 noise.
TRAIN_BF16_LOSS_RTOL = 5e-4
TRAIN_BF16_GRAD_REL = 1e-2
MEM_EST_RTOL = 0.1  # train_audio.step_peak_bytes against the measured peaks
SMALL_AST = {"embed_dim": 64, "depth": 2, "num_heads": 2, "feature_dim": 24}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, on CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# K1, K2 and the library calls beside them: calls of 0.05-0.5 ms, the first of
# them after an idle card. Two warm-up calls leave the first timing 30% high
# (0.078-0.080 ms where the next reads 0.060-0.064); ten do not.
STEADY = {"iters": 50, "warmup": 10}


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_l2(a, b) -> float:
    """|a - b| / |b| over the whole tensors (L2)."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _kernel_name(ptxas_line: str) -> str:
    """'attn_fwd_mma_kernel<64,1>' from ptxas's line naming a mangled kernel."""
    sym = ptxas_line.split("'")[1]
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", sym)
    if not m:
        return sym
    start = m.end() + int(m.group(1))
    args = (re.findall(r"L[a-z]+(\d+)E", sym[start:sym.find("EE", start) + 1])
            or [sym[start + 1:sym.find("E", start)]])  # a type argument, mangled
    return f"{sym[m.end():start]}<{','.join(args)}>"


# kernels that must build without spills: the wgmma attention kernels (the
# float32 K2 kernels spill by design) and the sampler
CLEAN_KERNELS = ("wgmma", "ddim_sampler")


def phase_build() -> dict:
    """Build every kernel source (one nvcc each, in parallel) -> ptxas's
    registers and spills by kernel."""
    from amuse_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build()
    seconds = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    log = "\n".join(f"== {name}.cu ({r['seconds']:.1f} s)\n{r['log']}" for name, r in results.items())
    (OUT / "build.log").write_text(log)
    ptxas, faults, kernel, per_kernel = [], [], "?", {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = _kernel_name(ln)
        elif "registers" in ln:
            ptxas.append(f"{kernel}: {ln.split(':', 1)[1].strip()}")
            per_kernel.setdefault(kernel, {})["registers"] = ln.split(":", 1)[1].strip()
        elif "spill stores" in ln:
            per_kernel.setdefault(kernel, {})["spills"] = ln.strip()
            if any(k in kernel for k in CLEAN_KERNELS) and any(
                    int(n) for n in re.findall(r"(\d+) bytes", ln)):
                faults.append(f"{kernel} spills: {ln.strip()}")
        if "wgmma.mma_async instructions are serialized" in ln:
            faults.append(ln.strip()[:300])
    emit({"phase": "build", "seconds": seconds,
          "sources": {n: r["seconds"] for n, r in results.items()}, "ptxas": ptxas,
          "faults": faults})
    # a kernel that spills, or whose wgmma pipeline ptxas had to serialise,
    # still computes the right numbers and is quietly slow
    check(not faults, "the kernels did not build clean:\n" + "\n".join(faults))
    return per_kernel


def phase_attention(rng_seed: int = 0) -> dict:
    """K1 against mha_reference at the AST shape (strided views of the fused
    qkv output, as vit_block feeds it) and at ragged S = 70: the largest and
    the relative L2 error of the output, the row log-sum-exp against
    torch.logsumexp, and the two instantiations' outputs bit for bit. At the
    AST shapes, N = 1, 4 (the train step's too) and 6 windows (one take of
    the edit and prepare_data paths), and at batch 4 (the shape of the
    benchmark folder's kernel variants V1, V3, V5), it is timed with and
    without the row log-sum-exp beside SDPA called both ways, with its
    achieved TFLOP/s and its share of the bound. -> {shape: case} of the
    AST shapes."""
    import torch
    import torch.nn.functional as F

    from amuse_tpu_torch.ops.attention import _launch_fwd, mha, mha_reference

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    cases = []
    for dtype, b, h, s, d, tol in ((torch.float32, 1, 2, 70, 32, K1_TOL_F32),
                                   (torch.float32, 2, 2, 70, 64, K1_TOL_F32),
                                   (torch.bfloat16, 1, 2, 70, 32, K1_TOL),
                                   (torch.bfloat16, 3, 12, 1214, 64, K1_TOL_AST),
                                   (torch.bfloat16, 4, 12, 1214, 64, K1_TOL_AST),
                                   (torch.bfloat16, 12, 12, 1214, 64, K1_TOL_AST),
                                   (torch.bfloat16, 18, 12, 1214, 64, K1_TOL_AST)):
        name = str(dtype).replace("torch.", "")
        qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = mha(q, k, v)
        out_lse, lse = _launch_fwd(q, k, v, with_lse=True)
        ref = mha_reference(q, k, v)
        lse_ref = torch.logsumexp(q.float() @ k.float().transpose(-1, -2) / math.sqrt(d), dim=-1)
        torch.cuda.synchronize()
        err, err_l2 = max_err(out, ref), rel_l2(out, ref)
        lse_excess = ((lse - lse_ref).abs() - 1e-5 * lse_ref.abs()).max().item()
        at = f"at {(b, h, s, d)} {name}"
        check(out.shape == ref.shape and torch.isfinite(out.float()).all().item(),
              f"K1 output bad {at}")
        check(err <= tol, f"K1 disagrees with its plain version {at}: {err} > {tol}")
        check(err_l2 <= K1_REL_L2[name], f"K1 disagrees with its plain version {at}: relative "
                                         f"L2 error {err_l2} > {K1_REL_L2[name]}")
        check(lse_excess <= K1_LSE_TOL[name], f"K1's row log-sum-exp {at} is off torch.logsumexp "
                                              f"by {lse_excess} > {K1_LSE_TOL[name]}")
        check(torch.equal(out, out_lse), f"K1 with and without the log-sum-exp differ {at}")
        case = {"shape": [b, h, s, d], "dtype": name, "max_abs_err": err, "tolerance": tol,
                "rel_l2_err": err_l2, "rel_l2_tolerance": K1_REL_L2[name],
                "lse_max_abs_err": max_err(lse, lse_ref), "lse_tolerance": K1_LSE_TOL[name]}
        del lse_ref
        if s == 1214:
            flops = 4.0 * b * h * s * s * d
            nbytes = 4.0 * b * h * s * d * q.element_size()  # q, k, v read, o written
            # the library call that also keeps the row log-sum-exp: SDPA on
            # inputs that need a gradient saves it for its backward
            lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
            case.update(
                ms=cuda_ms(lambda: mha(q, k, v), **STEADY),
                lse_ms=cuda_ms(lambda: _launch_fwd(q, k, v, with_lse=True), **STEADY),
                plain_ms=cuda_ms(lambda: mha_reference(q, k, v)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), **STEADY),
                library_lse_ms=cuda_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv),
                                       **STEADY),
                bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
                else "bytes",
            )
            case.update(tflops=flops / case["ms"] / 1e9, bound_share=case["bound_ms"] / case["ms"])
        cases.append(case)
    emit({"phase": "attention_k1", "cases": cases})
    return {tuple(c["shape"]): c for c in cases if c["shape"][2] == 1214}


def _sampler_flops(n: int, steps: int, t: int, d: int, ff: int, layers: int) -> float:
    per_layer = 2 * t * (4 * d * d + 2 * d * ff) + 4 * t * t * d
    per_step = layers * per_layer + ((layers - 1) // 2) * 2 * t * 2 * d * d
    return float(n * steps * per_step)


SMALL_DENOISER = {"latent_dim": 32, "ff_size": 64, "num_layers": 3, "num_heads": 2,
                  "cond_dim": 24}


def _k3_callables(den, sched, con, emo, sty, x0, steps: int) -> tuple:
    """(the launch alone, ddim_sample_fused as the pipeline calls it, cluster
    size). Also takes a checkout from before the cluster kernel (one block per
    window, the conditioning rebuilt per call; cluster None), so that
    ``--only-k3`` times the two checkouts in turns."""
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    if not hasattr(dk, "pack_for_cluster"):
        packed = dk.pack_denoiser(den)
        conditioning = dk.precompute_conditioning(den, sched, con, emo, sty, steps)
        return (lambda: dk.launch_sampler(packed, conditioning, x0, den.cfg),
                lambda: dk.ddim_sample_fused(den, sched, con, emo, sty, steps,
                                             initial_latents=x0, packed=packed), None)
    weights = dk.SamplerWeights(dk.pack_denoiser(den))
    pack = weights.for_cluster(dk.cluster_for(den.cfg, x0.shape[0]))
    sched_cond = dk.schedule_conditioning(den, sched, steps)
    cond = dk.condition_tokens(den, con, emo, sty)
    return (lambda: dk.launch_sampler(pack, sched_cond, cond, x0, den.cfg),
            lambda: dk.ddim_sample_fused(den, sched, con, emo, sty, steps, initial_latents=x0,
                                         packed=weights, conditioning=sched_cond), pack.cluster)


def _flagship_denoiser():
    import torch

    from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig

    torch.manual_seed(0)
    return Denoiser(DenoiserConfig()).cuda().eval()


def phase_k3_timing() -> list:
    """K3 at the flagship denoiser dims, 50 steps, 3 condition streams, at
    N = 1, 4, 8 and 32 windows (32 is more clusters of 8 than the card runs
    at once, so ``cluster_for`` takes a smaller size): the launch alone
    (``ms``) and through ``ddim_sample_fused`` as the pipeline calls it
    (``wrapper_ms``: the per-call condition tokens added),
    each held bit-equal to the other and to the plain loop within K3_TOL, the
    plain loop timed at N = 1, the bound from this call's shapes."""
    import torch

    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops.denoiser_kernel import ddim_sample_reference, pack_denoiser

    den, sched, steps = _flagship_denoiser(), make_schedule(), 50
    cfg = den.cfg
    weight_bytes = sum(t.numel() * 4 for t in pack_denoiser(den))
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for n in (1, 4, 8, 32):
        con, emo, sty = (torch.randn((n, cfg.cond_dim), generator=g, device="cuda")
                         for _ in range(3))
        x0 = torch.randn((n, 1, cfg.latent_dim), generator=g, device="cuda")
        kernel, wrapper, cluster = _k3_callables(den, sched, con, emo, sty, x0, steps)
        out = kernel()
        plain = lambda: ddim_sample_reference(den, sched, con, emo, sty, x0, steps)  # noqa: E731
        err = max_err(out, plain())
        check(torch.equal(wrapper(), out), f"K3 launched alone differs from its wrapper at N={n}")
        check(err <= K3_TOL, f"K3 disagrees with its plain loop at N={n}: {err} > {K3_TOL}")
        flops = _sampler_flops(n, steps, 5, cfg.latent_dim, cfg.ff_size, cfg.num_layers)
        nbytes = weight_bytes + 4.0 * (steps * (cfg.latent_dim + 4) + n * 5 * cfg.latent_dim)
        row = {"windows": n, "steps": steps, "real_tokens": 5, "cluster": cluster,
               "max_abs_err": err, "tolerance": K3_TOL,
               "ms": cuda_ms(kernel, iters=10, warmup=2),
               "wrapper_ms": cuda_ms(wrapper, iters=10, warmup=2),
               "bound_ms": max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
               "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES
               else "bytes"}
        row["ms_per_step"] = row["ms"] / steps
        if n == 1:
            row["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
        rows.append(row)
    emit({"phase": "sampler_k3_timing", "windows": rows})
    return rows


def phase_sampler() -> dict:
    """K3 against the plain DDIM loop: at the flagship denoiser dims (N = 1, 2
    and 8; 1 and 50 steps; 3, 2, 1 and no condition streams) and at small
    widths (d 32, ff 64, 3 layers, 2 heads), which run the same cluster
    kernel; two launches bit-equal. Then its launch plan at N = 1, the
    barriers one launch passed, the TF32 control of K3_TOL, and
    phase_k3_timing."""
    import torch

    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    sched = make_schedule()
    dens = {"flagship": _flagship_denoiser()}
    torch.manual_seed(3)
    dens["small"] = Denoiser(DenoiserConfig(**SMALL_DENOISER)).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for dims, n, steps, streams, tol in (
            ("flagship", 1, 1, 3, K3_TOL_STEP), ("flagship", 2, 50, 1, K3_TOL),
            ("flagship", 1, 50, 3, K3_TOL), ("flagship", 8, 50, 3, K3_TOL),
            ("flagship", 2, 50, 2, K3_TOL), ("flagship", 2, 50, 0, K3_TOL),
            ("flagship", 2, 1, 0, K3_TOL_STEP), ("small", 2, 1, 3, K3_TOL_STEP),
            ("small", 2, 50, 3, K3_TOL_SMALL), ("small", 3, 50, 2, K3_TOL_SMALL),
            ("small", 3, 50, 0, K3_TOL_SMALL)):
        den = dens[dims]
        cfg = den.cfg
        a, b, c = (torch.randn((n, cfg.cond_dim), generator=g, device="cuda")
                   for _ in range(3))
        con, emo, sty = {3: (a, b, c), 2: (a, None, c), 1: (a, None, None),
                         0: (None, None, None)}[streams]
        x0 = torch.randn((n, 1, cfg.latent_dim), generator=g, device="cuda")
        weights = dk.SamplerWeights(dk.pack_denoiser(den))
        pack = weights.for_cluster(dk.cluster_for(cfg, n))
        sched_cond = dk.schedule_conditioning(den, sched, steps)
        if streams:
            cond = dk.condition_tokens(den, con, emo, sty)
        else:  # latent and time tokens alone: launched directly
            cond = torch.empty((n, 0, cfg.latent_dim), device="cuda")
        out = dk.launch_sampler(pack, sched_cond, cond, x0, cfg)
        again = dk.launch_sampler(pack, sched_cond, cond, x0, cfg)
        ref = dk.ddim_sample_reference(den, sched, con, emo, sty, x0, steps)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        at = f"{dims} dims, N={n}, {steps} steps, {2 + cond.shape[1]} real tokens"
        check(torch.isfinite(out).all().item(), f"K3 output not finite at {at}")
        check(err <= tol, f"K3 disagrees with its plain loop at {at}: {err} > {tol}")
        check(torch.equal(out, again), f"two launches of K3 differ at {at}")
        if streams:
            fused = dk.ddim_sample_fused(den, sched, con, emo, sty, steps, initial_latents=x0,
                                         packed=weights, conditioning=sched_cond)
            check(torch.equal(fused, out), f"K3 through ddim_sample_fused differs at {at}")
        cases.append({"dims": dims, "windows": n, "steps": steps,
                      "real_tokens": 2 + cond.shape[1], "cluster": pack.cluster,
                      "max_abs_err": err, "tolerance": tol})
    den = dens["flagship"]
    cfg = den.cfg
    plan = dk.sampler_plan(cfg.latent_dim, cfg.ff_size, cfg.num_heads, cfg.num_layers,
                           dk.cluster_for(cfg, 1))
    emit({"phase": "sampler_k3", "cases": cases, "plan": plan,
          "barriers": _k3_barriers(den, sched, 50),
          "tf32_control": _k3_tf32_control(den, sched, 50)})
    return phase_k3_timing()[0]


def _k3_barriers(den, sched, steps: int) -> dict:
    """What one launch at N = 1 (flagship, 5 real tokens) passed, counted by
    the kernel's first CTA: cluster barriers, exchanges (waits on a receive
    mbarrier that the cluster's st.async stores complete) and block
    barriers, in all and per step."""
    import torch

    from amuse_tpu_torch.ops import denoiser_kernel as dk

    cfg = den.cfg
    g = torch.Generator(device="cuda").manual_seed(4)
    con, emo, sty = (torch.randn((1, cfg.cond_dim), generator=g, device="cuda")
                     for _ in range(3))
    x0 = torch.randn((1, 1, cfg.latent_dim), generator=g, device="cuda")
    pack = dk.pack_for_cluster(dk.pack_denoiser(den), dk.cluster_for(cfg, 1))
    stats = torch.zeros(3, dtype=torch.int32, device="cuda")
    dk.launch_sampler(pack, dk.schedule_conditioning(den, sched, steps),
                      dk.condition_tokens(den, con, emo, sty), x0, cfg, stats=stats)
    counts = dict(zip(("cluster_barriers", "exchanges", "block_barriers"), stats.tolist()))
    return {"cluster": pack.cluster, "steps": steps, "per_launch": counts,
            "per_step": {k: v / steps for k, v in counts.items()}}


def _k3_tf32_control(den, sched, steps: int) -> dict:
    """The plain loop with its products in TF32 against the same loop in
    float32 (flagship, N = 2, 5 real tokens): what K3_TOL must refuse."""
    import torch

    from amuse_tpu_torch.ops.denoiser_kernel import ddim_sample_reference

    cfg = den.cfg
    g = torch.Generator(device="cuda").manual_seed(5)
    con, emo, sty = (torch.randn((2, cfg.cond_dim), generator=g, device="cuda")
                     for _ in range(3))
    x0 = torch.randn((2, 1, cfg.latent_dim), generator=g, device="cuda")
    ref = ddim_sample_reference(den, sched, con, emo, sty, x0, steps)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = ddim_sample_reference(den, sched, con, emo, sty, x0, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"max_abs_err": max_err(tf32, ref), "tolerance": K3_TOL}


def _chunks(n: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).normal(scale=0.05, size=(n, 160000)).astype(np.float32)


def phase_small_reference():
    """The whole pipeline at small widths: kernels on the card against the
    plain versions on the CPU, same weights and initial latents (float32)."""
    import torch

    from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig

    cfgs = (PriorConfig(latent_dim=32, ff_size=64, num_layers=3, num_heads=2),
            DenoiserConfig(latent_dim=32, ff_size=64, num_layers=3, num_heads=2, cond_dim=24),
            ASTConfig(embed_dim=64, depth=2, num_heads=2, feature_dim=24))
    params = init_random_params(3, *cfgs)
    chunks = _chunks(2, 3)
    x0 = torch.randn((2, 1, 32), generator=torch.Generator().manual_seed(4))
    outs = {}
    for device in ("cpu", "cuda"):
        pipe = GesturePipeline(params, *cfgs, dtype=torch.float32, num_inference_steps=10,
                               device=device)
        poses, trans = pipe.wav_to_motion(chunks, initial_latents=x0)
        outs[device] = (axis_angle_to_matrix(poses).cpu(), trans.cpu())
    err = max(max_err(a, b) for a, b in zip(outs["cpu"], outs["cuda"]))
    check(err <= PIPE_TOL, f"small pipeline on the card disagrees with the CPU: {err}")
    emit({"phase": "pipeline_small_vs_cpu", "max_abs_err": err, "tolerance": PIPE_TOL})


def phase_main_path() -> dict:
    """wav_to_motion at the flagship widths, random weights, N = 1 and 4."""
    import torch

    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.ops import attention, denoiser_kernel

    t0 = time.perf_counter()
    pipe = GesturePipeline(init_random_params(0), device="cuda")
    setup_s = time.perf_counter() - t0
    depth = pipe.ast_cfg.depth
    counts, per_n = None, {}
    for n in (1, 4):
        chunks = _chunks(n, n)
        gen = torch.Generator(device="cuda").manual_seed(n)
        attention.mha.launches = 0
        denoiser_kernel.ddim_sample_fused.launches = 0
        poses, trans = pipe.wav_to_motion(chunks, generator=gen)
        torch.cuda.synchronize()
        launched = {"attention_fwd": attention.mha.launches,
                    "ddim_sampler": denoiser_kernel.ddim_sample_fused.launches}
        check(launched == {"attention_fwd": depth, "ddim_sampler": 1},
              f"main path at N={n} launched {launched}, expected {depth} K1 and 1 K3")
        check(tuple(poses.shape) == (n, 300, 55, 3) and tuple(trans.shape) == (n, 300, 3),
              f"wav_to_motion shapes {tuple(poses.shape)}, {tuple(trans.shape)}")
        check(torch.isfinite(poses).all().item() and torch.isfinite(trans).all().item(),
              "wav_to_motion output not finite")
        if counts is None:
            counts = launched
        ms = cuda_ms(lambda: pipe.wav_to_motion(chunks, generator=gen), iters=3, warmup=1)
        per_n[n] = {"ms_per_call": ms, "ms_per_window": ms / n}
    emit({"phase": "wav_to_motion", "setup_s": setup_s, "launches_per_call": counts,
          "windows": per_n, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    trace_wav_to_motion(pipe, _chunks(1, 1))
    return counts


def _device_rows(prof) -> list:
    """The kernels of a torch.profiler run, longest first: name, device ms in
    all, calls. User-annotated ranges (Optimizer.step) overlap the kernels
    they hold and are left out."""
    import torch

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            rows.append({"kernel": e.key, "ms": us / 1e3, "calls": e.count})
    return sorted(rows, key=lambda r: -r["ms"])


# The port's kernels (each source's kernels lie in an anonymous namespace) by
# the starts of their names, and how many each counted launch makes (K2: its
# row-statistics, dK/dV and dQ passes; a variant backward: its rows and
# columns passes): a profiled call must come back with that many records.
PORT_KERNEL_RECORDS = {
    "attention_fwd": (("attn_fwd",), 1), "attention_bwd": (("attn_bwd",), 3),
    "ddim_sampler": (("ddim_sampler_kernel",), 1),
    "variant_fwd": (("softmax_fwd_wgmma", "dots_fwd_wgmma", "fwd_f32<"), 1),
    "variant_bwd": (tuple(f"{b}_{p}_wgmma" for b in ("v4", "v1", "v0") for p in ("rows", "cols"))
                    + ("rows_f32<", "cols_f32<"), 2)}
# The profiler comes back short now and then: K2's first passes with 4 of 5
# records, a session of one cuBLAS GEMM with none after MFCC + DTW, the
# first session of each variant kernel and library call with none or some
# after the legacy phase (PERF.md, open questions). A short session is run
# again, up to this many in all, and the run fails if every one is short.
PROFILE_TRIES = 3
# The records lost were the first of the recorded step, for up to a few ms
# (K2: the first call's three kernels, or its first kernel after 0.1 s of
# idle time), as if the profiler had no buffer for them yet. So the step
# opens with sentinel kernels, whose records are dropped, and PROFILE_EDGE_S
# of idle time before fn(), and leaves the same after it.
PROFILE_EDGE_S = 0.1
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel


def _sentinels() -> None:
    import torch

    for _ in range(4):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
PROFILER = {"sessions": 0, "short": []}  # what the run's sessions gave, for its last lines


def _port_counts() -> dict:
    from amuse_tpu_torch.ops import kernel_variants as kv

    return {**_launch_counts(), "ddim_sampler": _sampler_launches(),
            "variant_fwd": kv.variant_fwd.launches, "variant_bwd": kv.variant_bwd.launches}


def _short_port_records(rows: list, before: dict, after: dict) -> str:
    """"" when the profiler recorded every launch of the port's kernels that
    the wrappers counted between ``before`` and ``after``, else what is short."""
    short = []
    for name, (marks, per_launch) in PORT_KERNEL_RECORDS.items():
        recorded = sum(r["calls"] for r in rows
                       if any(f"(anonymous namespace)::{m}" in r["kernel"] for m in marks))
        want = per_launch * (after[name] - before[name])
        if recorded != want:
            short.append(f"{name}: {recorded} records for {want} kernels counted")
    return "; ".join(short)


def _profile(fn, what: str, trace: str | None = None, whole=None) -> tuple:
    """fn() under torch.profiler (CUPTI) -> (``_device_rows``, host wall ms of
    fn() with its synchronisation). A session opens with a warm-up step,
    and the recorded step with sentinel kernels and PROFILE_EDGE_S before
    fn() and as long after it; the sentinels' records are dropped. It must
    record every launch of the port's kernels that their wrappers count
    (PORT_KERNEL_RECORDS), and ``whole(rows)``, where given, must return ""
    (else what is short); a short session is run again (PROFILE_TRIES).
    ``trace``: also record host events and write the Chrome trace to
    ``OUT / "<trace>_trace.json"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if trace else [])
    for _ in range(PROFILE_TRIES):
        rows, wall = [], []

        def ready(p):
            rows.extend(r for r in _device_rows(p) if SENTINEL not in r["kernel"])
            if trace:
                p.export_chrome_trace(str(OUT / f"{trace}_trace.json"))

        before = _port_counts()
        with profile(activities=activities, on_trace_ready=ready,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            _sentinels()
            prof.step()
            _sentinels()
            time.sleep(PROFILE_EDGE_S)
            _sentinels()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            time.sleep(PROFILE_EDGE_S)
            prof.step()
        PROFILER["sessions"] += 1
        short = "; ".join(x for x in (_short_port_records(rows, before, _port_counts()),
                                      whole(rows) if whole else "") if x)
        if not short:
            return rows, wall[0]
        PROFILER["short"].append(f"{what}: {short}")
        print(f"profiler: a session of {what} came back short: {short}", file=sys.stderr)
    check(False, f"the profiler came back short in {PROFILE_TRIES} sessions of {what}: {short}")


def trace_call(fn, name: str) -> dict:
    """Device time by kernel for one call of fn() (``_profile``): the call's
    host wall time (the profiler's overhead included), the device busy
    time, launches and the longest kernels. The Chrome trace goes to
    ``OUT / "<name>_trace.json"``."""
    rows, wall_ms = _profile(fn, f"the trace of {name}", name)
    return {"wall_ms": wall_ms, "device_busy_ms": sum(r["ms"] for r in rows),
            "device_kernels": len(rows), "device_launches": sum(r["calls"] for r in rows),
            "top": [{**r, "kernel": r["kernel"][:90]} for r in rows[:12]]}


def trace_wav_to_motion(pipe, chunks) -> None:
    """One wav_to_motion call, traced."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    emit({"phase": "trace_wav_to_motion", "windows": chunks.shape[0],
          **trace_call(lambda: pipe.wav_to_motion(chunks, generator=gen), "wav_to_motion")})


def phase_cli():
    """The port's infer_gesture CLI on a synthetic 20 s WAV in a temporary directory."""
    import numpy as np

    from amuse_tpu_torch.audio.wavio import save_wav

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "wavs").mkdir()
        wave = np.random.default_rng(5).normal(scale=0.05, size=320000).astype(np.float32)
        save_wav(tmp / "wavs" / "2_scott_0_9_9.wav", wave)
        (tmp / "cfg.json").write_text(json.dumps({"out_dir": str(tmp / "runs")}))
        env = {k: v for k, v in os.environ.items() if k != "AMUSE_TPU_CKPT"}
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "amuse_tpu_torch.cli.main", "--fn", "infer_gesture",
             "--cfg", str(tmp / "cfg.json"), "--wav-dir", str(tmp / "wavs")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        (OUT / "cli.log").write_text(r.stdout + r.stderr)
        check(r.returncode == 0, f"infer_gesture CLI failed (rc {r.returncode}):\n{r.stderr[-2000:]}")
        seqs = sorted(tmp.glob("runs/*/gesture/2_scott_0_9_9/rep0/seq_*/*.npz"))
        check(len(seqs) == 2, f"CLI wrote {len(seqs)} seq npz files, expected 2")
        for p in seqs:
            d = np.load(p)
            check(d["poses"].shape == (300, 55, 3) and np.isfinite(d["poses"]).all(),
                  f"bad npz {p.name}")
    emit({"phase": "cli_infer_gesture", "seconds": seconds, "seq_files": len(seqs)})


def phase_attention_k2(rng_seed: int = 0) -> dict:
    """K2 through mha_train's backward, on strided views of a fused qkv
    tensor (as vit_block feeds it), against mha_bwd_reference and against
    autograd through mha_reference: float32 at ragged S = 70 (D 32 and 64),
    bf16 at the shape of the benchmark folder's variants V2, V4 (4, 12, 1214,
    64) and at the stage-1 shape (3 encoders x 4 fbanks, 12 heads, 1214,
    64), where two launches must agree bit for bit and the call is timed
    beside the SDPA backward (on CUDA events and as device time,
    ``library_device_ms``), whole and pass by pass (``passes_ms``)."""
    import torch
    import torch.nn.functional as F

    from amuse_tpu_torch.ops.attention import (_launch_fwd, mha_bwd, mha_bwd_reference,
                                               mha_reference, mha_train)

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    cases = []
    for dtype, b, h, s, d in ((torch.float32, 1, 2, 70, 32), (torch.float32, 2, 2, 70, 64),
                              (torch.bfloat16, 4, 12, 1214, 64),
                              (torch.bfloat16, 12, 12, 1214, 64)):
        name = str(dtype).replace("torch.", "")
        qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(dtype)
        do = torch.randn((b, h, s, d), generator=g, device="cuda").to(dtype)
        leaf = qkv.clone().requires_grad_()
        mha_train(leaf).backward(do)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        plain = mha_bwd_reference(q, k, v, do)
        ref_leaf = qkv.clone().requires_grad_()
        mha_reference(*(ref_leaf[:, :, i].transpose(1, 2) for i in range(3))).backward(do)
        torch.cuda.synchronize()
        err, tol, err_l2 = 0.0, math.inf, 0.0
        for i in range(3):
            got = leaf.grad[:, :, i].transpose(1, 2)
            check(torch.isfinite(got.float()).all().item(),
                  f"K2 output not finite at {(b, h, s, d)}")
            for ref in (plain[i], ref_leaf.grad[:, :, i].transpose(1, 2)):
                e, t = max_err(got, ref), K2_REL[name] * ref.float().abs().max().item()
                e_l2 = rel_l2(got, ref)
                check(e <= t, f"K2 disagrees with its plain version at {(b, h, s, d)} {name}, "
                              f"gradient {'qkv'[i]}: {e} > {t}")
                check(e_l2 <= K2_REL_L2[name],
                      f"K2 disagrees with its plain version at {(b, h, s, d)} {name}, gradient "
                      f"{'qkv'[i]}: relative L2 error {e_l2} > {K2_REL_L2[name]}")
                err, tol, err_l2 = max(err, e), min(tol, t), max(err_l2, e_l2)
        case = {"shape": [b, h, s, d], "dtype": name, "max_abs_err": err, "tolerance": tol,
                "tolerance_rel": K2_REL[name], "rel_l2_err": err_l2,
                "rel_l2_tolerance": K2_REL_L2[name]}
        if s == 1214:
            out, lse = _launch_fwd(q, k, v, with_lse=True)
            flops = 10.0 * b * h * s * s * d
            nbytes = 8.0 * b * h * s * d * q.element_size() + 4.0 * b * h * s  # + lse
            lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(lq, lk, lv)
            check(torch.equal(mha_bwd(q, k, v, out, do, lse), mha_bwd(q, k, v, out, do, lse)),
                  "two launches of K2 on the same inputs differ")
            case.update(
                ms=cuda_ms(lambda: mha_bwd(q, k, v, out, do, lse), **STEADY),
                plain_ms=cuda_ms(lambda: mha_bwd_reference(q, k, v, do), iters=3, warmup=1),
                library_ms=cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                                               retain_graph=True), **STEADY),
                bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
                else "bytes",
            )
            case.update(tflops=flops / case["ms"] / 1e9, bound_share=case["bound_ms"] / case["ms"],
                        passes_ms=_kernel_times(lambda: mha_bwd(q, k, v, out, do, lse),
                                                "attn_bwd"),
                        library_device_ms=device_ms(lambda: torch.autograd.grad(
                            lib_out, (lq, lk, lv), do, retain_graph=True)))
        cases.append(case)
    emit({"phase": "attention_k2", "cases": cases})
    return cases[-1]


def device_ms(fn) -> float:
    """Device ms of one call of fn(): its kernels' times summed
    (``_kernel_times``), gaps between them left out."""
    return sum(_kernel_times(fn, "").values())


def _kernel_times(fn, mark: str, calls: int = 5) -> dict:
    """Device ms per call of fn() of each kernel whose name holds ``mark``
    (every kernel for ``""``), over ``calls`` calls after one warm-up call
    (``_profile``: the port's kernels with a record for each launch). At
    least one such kernel, each with a whole number of records a call."""
    import torch

    def whole(rows) -> str:
        counts = {r["kernel"][:60]: r["calls"] for r in rows if mark in r["kernel"]}
        ok = counts and all(n % calls == 0 for n in counts.values())
        return "" if ok else f"{counts} records of kernels holding {mark!r} in {calls} calls"

    fn()
    torch.cuda.synchronize()
    rows, _ = _profile(lambda: [fn() for _ in range(calls)],
                       f"{calls} calls of {mark or 'a library call'}", whole=whole)
    return {r["kernel"][r["kernel"].find(mark):].split("(")[0][:90]: r["ms"] / calls
            for r in rows if mark in r["kernel"]}


def _train_batch(b: int, t: int, f: int, seed: int, device) -> dict:
    import numpy as np

    from amuse_tpu_torch.train.audio import batch_to_device

    rng = np.random.default_rng(seed)
    return batch_to_device({"fbanks": rng.normal(size=(b, 4, t, f)).astype(np.float32),
                            "emo_id": rng.integers(0, 8, b), "a1_id": rng.integers(0, 30, b),
                            "a2_id": rng.integers(0, 30, b)}, device)


def _launch_counts() -> dict:
    from amuse_tpu_torch.ops import attention

    return {"attention_fwd": attention.mha.launches, "attention_bwd": attention.mha_bwd.launches}


def _reset_counts() -> None:
    from amuse_tpu_torch.ops import attention, denoiser_kernel, kernel_variants

    attention.mha.launches = attention.mha_bwd.launches = 0
    denoiser_kernel.ddim_sample_fused.launches = 0
    kernel_variants.variant_fwd.launches = kernel_variants.variant_bwd.launches = 0


def _small_steps(dtype, device: str) -> tuple:
    """Two stage-1 steps at the small widths of ``phase_train_small_vs_cpu``
    -> (losses, gradients per step, parameters after, launch counts)."""
    import torch

    from amuse_tpu_torch.models.ast import ASTConfig, ASTDisentangler
    from amuse_tpu_torch.train import audio as ta

    cfg = ta.AudioTrainConfig(learning_rate=TRAIN_LR)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        model = ASTDisentangler(ASTConfig(**SMALL_AST), fusion_dim=64, dtype=dtype).to(device)
    state = ta.AudioTrainState(model, ta.make_optimizer(model, cfg))
    step, _ = ta.make_train_step(cfg)
    batch = _train_batch(1, 1024, 128, 12, torch.device(device))
    losses, grads = [], []
    _reset_counts()
    for _ in range(2):
        losses.append(step(state, batch, None, stochastic=False)["total"].item())
        grads.append({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    return (losses, grads, {n: p.detach().cpu() for n, p in model.named_parameters()},
            _launch_counts())


def _grad_rel_l2(got: dict, want: dict) -> float:
    """|got - want| / |want| over all gradients together (L2)."""
    num = sum(((got[n] - g) ** 2).sum().item() for n, g in want.items())
    return (num / sum((g ** 2).sum().item() for g in want.values())) ** 0.5


def phase_train_small_vs_cpu():
    """Two stage-1 train steps at small widths (AST embed 64, 2 heads of 32,
    depth 2, the real 1024x128 fbank, fusion width 64; dropout and
    augmentation off): the card (K1, K2, fused Adam) against the CPU plain
    path from the same weights and batch, in float32 (loss per step, every
    gradient of step 1, the parameters after step 2) and in bf16 over
    float32 parameters, the main path's precision (loss per step, the
    gradients of step 1)."""
    import torch

    runs = {(dt, dev): _small_steps(dt, dev) for dt in (torch.float32, torch.bfloat16)
            for dev in ("cpu", "cuda")}
    (l_cpu, g_cpu, p_cpu, _), (l_gpu, g_gpu, p_gpu, _) = (
        runs[torch.float32, "cpu"], runs[torch.float32, "cuda"])
    want = {"attention_fwd": 2 * SMALL_AST["depth"], "attention_bwd": 2 * SMALL_AST["depth"]}
    for dt in (torch.float32, torch.bfloat16):
        n_cpu, n_gpu = runs[dt, "cpu"][3], runs[dt, "cuda"][3]
        check(n_cpu == {"attention_fwd": 0, "attention_bwd": 0} and n_gpu == want,
              f"small {dt} train steps launched {n_gpu} on the card, {n_cpu} on the CPU; "
              f"expected {want}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    check(loss_err <= TRAIN_LOSS_RTOL, f"small train step loss on the card vs CPU: {loss_err}")
    grad_err = max((g_gpu[0][n] - g).abs().max().item() / g.abs().max().item()
                   for n, g in g_cpu[0].items() if g.abs().max() > 0)
    check(g_gpu[0].keys() == g_cpu[0].keys() and grad_err <= TRAIN_GRAD_REL,
          f"small train step gradients on the card vs CPU: {grad_err}")
    # Adam's update is ~ +-lr wherever |g| >> eps: compare where both steps'
    # gradients are well above it (a gradient that is 0 in exact arithmetic,
    # the attention key bias, gets its sign from rounding noise)
    param_err = 0.0
    for n, g in g_cpu[0].items():
        keep = (g.abs() > 1e-5) & (g_cpu[1][n].abs() > 1e-5)
        if keep.any():
            param_err = max(param_err, (p_gpu[n] - p_cpu[n]).abs()[keep].max().item())
    check(param_err <= TRAIN_LR / 10, f"parameters after two steps, card vs CPU: {param_err}")
    (lb_cpu, gb_cpu, pb_cpu, _), (lb_gpu, gb_gpu, pb_gpu, _) = (
        runs[torch.bfloat16, "cpu"], runs[torch.bfloat16, "cuda"])
    check(gb_gpu[0].keys() == gb_cpu[0].keys()
          and all(g.dtype == torch.float32 for g in gb_gpu[0].values()),
          "bf16 small train step: gradients missing or not float32")
    bf16 = {"loss_cpu": lb_cpu, "loss_gpu": lb_gpu,
            "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(lb_gpu, lb_cpu)),
            "loss_tolerance": TRAIN_BF16_LOSS_RTOL,
            "grad_rel_l2": _grad_rel_l2(gb_gpu[0], gb_cpu[0]),
            "grad_tolerance": TRAIN_BF16_GRAD_REL,
            "param_max_abs_err": max((pb_gpu[n] - pb_cpu[n]).abs().max().item() for n in pb_cpu),
            # what bf16 itself costs, on the CPU: bf16 against float32
            "gap_to_float32": {
                "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(lb_cpu, l_cpu)),
                "grad_rel_l2": _grad_rel_l2(gb_cpu[0], g_cpu[0])}}
    check(bf16["loss_rel_err"] <= TRAIN_BF16_LOSS_RTOL,
          f"bf16 small train step loss on the card vs CPU: {bf16['loss_rel_err']}")
    check(bf16["grad_rel_l2"] <= TRAIN_BF16_GRAD_REL,
          f"bf16 small train step gradients on the card vs CPU: {bf16['grad_rel_l2']}")
    emit({"phase": "train_small_vs_cpu", "loss_cpu": l_cpu, "loss_gpu": l_gpu,
          "loss_rel_err": loss_err, "loss_tolerance": TRAIN_LOSS_RTOL,
          "grad_rel_err": grad_err, "grad_tolerance": TRAIN_GRAD_REL,
          "param_max_abs_err": param_err, "param_tolerance": TRAIN_LR / 10,
          "launches_two_steps": runs[torch.float32, "cuda"][3], "bfloat16": bf16})


def phase_train_step(steps: int = 4) -> dict:
    """The stage-1 train step at the flagship widths (AST 768 x 12 x 3,
    fusion 768 -> 512, decoder 512 -> 1024 x 128), bf16 compute over float32
    parameters, batch 1 quad (configs/train_audio.json), random weights,
    synthetic fbanks, dropout and augmentation on: one warm-up step, then
    ``steps`` timed steps on CUDA events, counted, then one traced step.
    Last, one step at 3 quads without remat for its peak memory: both peaks
    against ``train.audio.step_peak_bytes``, the estimate the train_audio
    CLI switches remat on by. Returns the launches per step."""
    import torch

    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.train import audio as ta

    cfg, ast_cfg = ta.AudioTrainConfig(), ASTConfig()
    t0 = time.perf_counter()
    state = ta.init_state(0, cfg, torch.bfloat16, ast_cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    step, set_lr = ta.make_train_step(cfg)
    set_lr(state, 0)
    batch = _train_batch(1, ast_cfg.input_tdim, ast_cfg.input_fdim, 1, torch.device("cuda"))
    watched = ("emo_enc.v.blocks.0.attn.qkv.weight", "con_enc.v.blocks.11.mlp.fc2.weight",
               "decode.projection.2.weight")
    params = dict(state.model.named_parameters())
    before = {n: params[n].detach().clone() for n in watched}
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, ta.step_generator(0, 0, 0, "cuda"))  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    host_ms = []  # time for step() to return: the host's enqueue of the step
    events[0].record()
    for i in range(steps):
        t0 = time.perf_counter()
        logs = step(state, batch, ta.step_generator(0, 0, i + 1, "cuda"))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events[i + 1].record()
    torch.cuda.synchronize()
    counts = _launch_counts()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    ms = sum(step_ms) / steps
    want = {"attention_fwd": ast_cfg.depth * steps, "attention_bwd": ast_cfg.depth * steps}
    check(counts == want, f"train steps launched {counts}, expected {want} (one K1 and one K2 "
                          f"per ViT block per step, the three encoders stacked)")
    loss = logs["total"].item()
    check(math.isfinite(loss), f"train step loss not finite: {loss}")
    moved = {n: (params[n].detach() - before[n]).abs().max().item() for n in watched}
    check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")
    peak1 = torch.cuda.max_memory_allocated()
    with torch.no_grad():  # the per-step stack + bf16 cast of the three trunks, forward only
        stack_ms = cuda_ms(state.model.stacked_trunks, iters=5, warmup=1)
    per_step = {k: v // steps for k, v in counts.items()}
    emit({"phase": "train_audio_step", "setup_s": setup_s, "params": n_params, "steps": steps,
          "ms_per_step": ms, "device_ms_each": step_ms, "host_ms_each": host_ms,
          "loss": loss, "logs": {k: v.item() for k, v in logs.items()},
          "launches_per_step": per_step, "peak_mem_gib": peak1 / 2**30, "param_moved": moved,
          "stack_trunks_ms": stack_ms})
    trace_train_step(state, step, batch)
    torch.cuda.reset_peak_memory_stats()
    big = _train_batch(3, ast_cfg.input_tdim, ast_cfg.input_fdim, 2, torch.device("cuda"))
    logs = step(state, big, ta.step_generator(0, 0, 100, "cuda"))
    check(math.isfinite(logs["total"].item()), "3-quad train step loss not finite")
    peak3 = torch.cuda.max_memory_allocated()
    elements = 12 * ast_cfg.depth * (ast_cfg.num_patches + 2) * ast_cfg.embed_dim
    est = {q: ta.step_peak_bytes(ast_cfg, q, torch.bfloat16) for q in (1, 3)}
    mem = {"peak_gib": {1: peak1 / 2**30, 3: peak3 / 2**30},
           "estimate_gib": {q: e / 2**30 for q, e in est.items()},
           "act_bytes_per_element": (peak3 - peak1) / 2 / elements,
           "fixed_bytes_per_param": (peak1 - (peak3 - peak1) / 2) / n_params,
           "remat_from_quads": next(q for q in range(1, 1000) if ta.remat_needed(
               ast_cfg, q, torch.bfloat16, torch.device("cuda")))}
    emit({"phase": "train_audio_memory", "remat": False, **mem})
    for q, peak in ((1, peak1), (3, peak3)):
        check(abs(est[q] / peak - 1) <= MEM_EST_RTOL,
              f"step_peak_bytes at {q} quads: {est[q] / 2**30:.2f} GiB against the measured "
              f"{peak / 2**30:.2f} GiB")
    return per_step


def trace_train_step(state, step, batch) -> None:
    """Device time by kernel for one train step (``_profile``)."""
    from amuse_tpu_torch.train.audio import step_generator

    rows, wall_ms = _profile(lambda: step(state, batch, step_generator(0, 0, 99, "cuda")),
                             "the trace of the train step", "train_step")
    families = {}
    for r in rows:
        family = next((f for f, marks in _KERNEL_FAMILIES if any(m in r["kernel"] for m in marks)),
                      "other elementwise and reductions")
        families[family] = families.get(family, 0.0) + r["ms"]
    emit({"phase": "trace_train_audio_step", "wall_ms": wall_ms,
          "device_busy_ms": sum(r["ms"] for r in rows), "device_kernels": len(rows),
          "device_launches": sum(r["calls"] for r in rows),
          "families_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
          "top": [{**r, "kernel": r["kernel"][:90]} for r in rows[:15]]})


# kernel families of the traced train step, by substrings of the kernel name
_KERNEL_FAMILIES = (
    ("K2 dK/dV pass", ("attn_bwd_dkdv",)), ("K2 dQ pass", ("attn_bwd_dq",)),
    ("K2 row-statistics pass", ("attn_bwd_stats", "attn_bwd_delta")), ("K1", ("attn_fwd",)),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "xmma")), ("fused Adam", ("multi_tensor_apply",)),
    ("copies, casts, stack, cat", ("copy", "CatArray")), ("LayerNorm", ("layer_norm",)),
)


def phase_cli_train():
    """The port's train_audio CLI at tiny widths (bf16, head dim 32) on a
    synthetic stage-1 npz written by the port's save_dataset: one epoch with
    a checkpoint, then a resume that runs a second epoch."""
    import numpy as np

    from amuse_tpu_torch.data.stage1 import save_dataset

    rng = np.random.default_rng(8)

    def split(n, m):
        return {"fbank_bank": rng.normal(size=(m, 64, 32)).astype(np.float32),
                "quad_idx": rng.integers(0, m, (n, 4)).astype(np.int32),
                "emo_id": rng.integers(0, 8, n).astype(np.int32),
                "a1_id": rng.integers(0, 30, n).astype(np.int32),
                "a2_id": rng.integers(0, 30, n).astype(np.int32)}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_dataset(tmp / "stage1.npz", split(6, 10), split(2, 4), ["1/a"])
        cfg = {"data": {"stage1_dataset": str(tmp / "stage1.npz")}, "out_dir": str(tmp / "runs"),
               "dtype": "bfloat16",
               "audio": {"ast_embed_dim": 64, "ast_depth": 1, "ast_heads": 2,
                         "ast_feature_dim": 16, "target_length": 64, "num_mel_bins": 32,
                         "freq_mask": 4, "time_mask": 8, "epochs": 1, "batch_size": 2}}
        (tmp / "cfg.json").write_text(json.dumps(cfg))
        base = [sys.executable, "-m", "amuse_tpu_torch.cli.main", "--fn", "train_audio",
                "--cfg", str(tmp / "cfg.json")]
        log = OUT / "cli_train.log"

        def run_cli(*extra):
            r = subprocess.run(base + list(extra), cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            with open(log, "a") as f:
                f.write(r.stdout + r.stderr)
            check(r.returncode == 0, f"train_audio CLI failed (rc {r.returncode}):\n"
                                     f"{r.stderr[-2000:]}")
            return r

        t0 = time.perf_counter()
        first = run_cli()
        (run,) = (tmp / "runs").iterdir()
        ckpt = run / "checkpoints"
        check("epoch 1/1" in first.stdout and (ckpt / "step_00000001" / "state.pt").exists(),
              "train_audio CLI wrote no epoch-1 checkpoint")
        second = run_cli("--set", f"resume={ckpt}", "--set", "audio.epochs=2")
        seconds = time.perf_counter() - t0
        check("resumed full train state" in second.stdout and "epoch 2/2" in second.stdout
              and "epoch 1/2" not in second.stdout, "train_audio resume did not continue")
        metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        check(all(math.isfinite(m["train_total"]) for m in metrics), "CLI loss not finite")
    emit({"phase": "cli_train_audio", "seconds": seconds, "epochs_logged": len(metrics),
          "last": second.stdout.strip().splitlines()[-1][:300]})


# stage-2 (LPDM) training: the small-width step on the card against the CPU
# plain path (float32, dropout off, the step's draws made on the CPU): the
# loss per step and all gradients of step 1 together (relative L2)
LPDM_LOSS_RTOL = 1e-3
LPDM_GRAD_REL_L2 = 1e-3
SMALL_PRIOR = {"latent_dim": 32, "ff_size": 64, "num_layers": 3, "num_heads": 2, "window": 30}
LPDM_BATCH = 32  # configs/train_gesture.json


def _lpdm_batch(b: int, t: int, cond: int, seed: int, device) -> dict:
    """A stage-2 batch: axis-angle motion + trans, frozen-AST features, and the
    MoSh betas of random actors among the 26 whose betas the repository has."""
    import numpy as np

    from amuse_tpu_torch.data.actors import ACTORS, _load_betas
    from amuse_tpu_torch.data.cache import betas_for_actor_ids
    from amuse_tpu_torch.train.gesture import batch_to_device

    rng = np.random.default_rng(seed)
    with_betas = [i - 1 for i, a in ACTORS.items() if a.name in _load_betas()]
    return batch_to_device({"motion": 0.2 * rng.normal(size=(b, t, 168)),
                            "con": rng.normal(size=(b, cond)), "emo": rng.normal(size=(b, cond)),
                            "sty": rng.normal(size=(b, cond)),
                            "betas": betas_for_actor_ids(rng.choice(with_betas, b))}, device)


def _small_lpdm(device: str, lr: float = TRAIN_LR, dropout: float = 0.0):
    """(state, step) of the small-width LPDM step: prior and denoiser
    d 32, 30-frame windows, the 50-step monitor, and the vertex monitors on a
    64-vertex rig of the SMPL-X tree, all on ``device``."""
    import dataclasses

    from amuse_tpu_torch.core import smplx
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.train import gesture as tg

    prior_cfg = PriorConfig(**SMALL_PRIOR, dropout=dropout)
    den_cfg = DenoiserConfig(**SMALL_DENOISER, dropout=dropout)
    tcfg = dataclasses.replace(tg.GestureTrainConfig(), learning_rate=lr)
    rig = smplx.make_test_model(num_vertices=64, num_joints=55, num_betas=300,
                                parents=smplx.SMPLX_PARENTS).to(device)
    state = tg.init_state(21, prior_cfg, den_cfg, tcfg, device)
    return state, tg.make_train_step(prior_cfg, den_cfg, tcfg, rig)


def _cpu_noise(b: int, seed: int, device):
    """A step's draws made by a CPU generator (CUDA's and the CPU's draw
    different numbers), on ``device``."""
    import torch

    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.train import gesture as tg

    noise = tg.draw_step_noise(torch.Generator().manual_seed(seed), b,
                               PriorConfig(**SMALL_PRIOR), make_schedule(), torch.device("cpu"))
    return tg.StepNoise(*(x.to(device) for x in noise))


def _monitor_gen_feature(prior, den, batch, x_t, steps: int = 50) -> float:
    """The monitor's gen_feature by the plain loop over these weights."""
    import torch

    from amuse_tpu_torch.core.motion import featurize
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops.denoiser_kernel import ddim_sample_reference
    from amuse_tpu_torch.train.losses import smooth_l1

    with torch.no_grad():
        z = ddim_sample_reference(den.eval(), make_schedule(), batch["con"], batch["emo"],
                                  batch["sty"], x_t, steps)
        return smooth_l1(prior.eval().decode(z), featurize(batch["motion"])).item()


def phase_train_gesture_small_vs_cpu() -> dict:
    """The LPDM step at small widths (SMALL_PRIOR, SMALL_DENOISER, batch 4,
    the 50-step monitor and the vertex monitors), three checks:

      * two steps on the card against the CPU from the same weights, batch and
        draws, dropout off: loss per step within LPDM_LOSS_RTOL, the
        gradients of step 1 within LPDM_GRAD_REL_L2; one K3 launch per step
        on the card, none on the CPU;
      * K3 after AdamW steps: at lr 1e-2, the gen_feature a step logs equals
        the plain loop over the weights that step started from (the updated
        ones) within K3's error, and differs from the plain loop over the
        weights of one step earlier by far more; ``ddim_sample_fused`` over
        the updated denoiser against ``ddim_sample_reference`` (K3_TOL_SMALL);
      * an epoch of 4 stochastic steps (dropout 0.1) with its batches from
        ``prefetch_to_device`` bit-equal to the same epoch with batches
        copied on the default stream: each step's logs and the parameters."""
    import copy

    import torch

    from amuse_tpu_torch.data.prefetch import prefetch_to_device
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops import denoiser_kernel as dk
    from amuse_tpu_torch.train.audio import step_generator

    b = 4
    runs = {}
    for device in ("cpu", "cuda"):
        state, step = _small_lpdm(device)
        batch = _lpdm_batch(b, 30, 24, 3, torch.device(device))
        _reset_counts()
        losses, grads = [], None
        for i in range(2):
            losses.append(step(state, batch, stochastic=False,
                               noise=_cpu_noise(b, 10 + i, device))["total"].item())
            if grads is None:
                grads = {n: p.grad.detach().cpu().clone()
                         for m in (state.prior, state.denoiser) for n, p in m.named_parameters()
                         if p.grad is not None}
        runs[device] = (losses, grads, _sampler_launches())
    (l_cpu, g_cpu, k_cpu), (l_gpu, g_gpu, k_gpu) = runs["cpu"], runs["cuda"]
    check(k_cpu == 0 and k_gpu == 2, f"small LPDM steps launched K3 {k_gpu} times on the card "
                                     f"and {k_cpu} on the CPU; expected 2 and 0")
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(l_gpu, l_cpu))
    grad_err = _grad_rel_l2(g_gpu, g_cpu)
    check(g_gpu.keys() == g_cpu.keys() and loss_err <= LPDM_LOSS_RTOL
          and grad_err <= LPDM_GRAD_REL_L2,
          f"small LPDM step on the card vs CPU: loss {loss_err}, gradients {grad_err}")

    # the monitor samples with the weights of the step it runs in
    state, step = _small_lpdm("cuda", lr=1e-2)
    batch = _lpdm_batch(b, 30, 24, 4, torch.device("cuda"))
    before = (copy.deepcopy(state.prior), copy.deepcopy(state.denoiser))
    step(state, batch, stochastic=False, noise=_cpu_noise(b, 20, "cuda"))
    updated = (copy.deepcopy(state.prior), copy.deepcopy(state.denoiser))
    noise = _cpu_noise(b, 21, "cuda")
    logged = step(state, batch, stochastic=False, noise=noise)["gen_feature"].item()
    fresh = _monitor_gen_feature(*updated, batch, noise.latents)
    stale = _monitor_gen_feature(*before, batch, noise.latents)
    check(abs(logged - fresh) * 10 < abs(logged - stale),
          f"the monitor's gen_feature {logged} is not that of the updated weights ({fresh}) "
          f"rather than the earlier ones ({stale})")
    den = state.denoiser.eval()
    out = dk.ddim_sample_fused(den, make_schedule(), batch["con"], batch["emo"], batch["sty"],
                               50, initial_latents=noise.latents)
    ref = dk.ddim_sample_reference(den, make_schedule(), batch["con"], batch["emo"],
                                   batch["sty"], noise.latents, 50)
    k3_err = max_err(out, ref)
    check(k3_err <= K3_TOL_SMALL, f"K3 over the updated weights vs the plain loop: {k3_err}")

    # prefetch: the copy on the side stream is waited for
    def host_batches():
        import numpy as np

        for i in range(4):
            cpu = _lpdm_batch(b, 30, 24, 30 + i, torch.device("cpu"))
            yield {k: np.asarray(v) for k, v in cpu.items()}

    epochs = {}
    for name in ("prefetch", "default_stream"):
        state, step = _small_lpdm("cuda", dropout=0.1)
        feed = (prefetch_to_device(host_batches(), 2, "cuda") if name == "prefetch" else
                ({k: torch.as_tensor(v).to("cuda") for k, v in hb.items()}
                 for hb in host_batches()))
        logs = [step(state, batch, step_generator(5, 0, i, "cuda")) for i, batch in
                enumerate(feed)]
        epochs[name] = ([{k: v.item() for k, v in lg.items()} for lg in logs],
                        [p.detach().clone() for m in (state.prior, state.denoiser)
                         for p in m.parameters()])
    (la, pa), (lb, pb) = epochs["prefetch"], epochs["default_stream"]
    check(len(la) == 4 and la == lb and all(torch.equal(x, y) for x, y in zip(pa, pb)),
          "an epoch fed by prefetch_to_device differs from the same epoch fed on the "
          "default stream")
    row = {"phase": "train_gesture_small_vs_cpu", "loss_cpu": l_cpu, "loss_gpu": l_gpu,
           "loss_rel_err": loss_err, "loss_tolerance": LPDM_LOSS_RTOL,
           "grad_rel_l2": grad_err, "grad_tolerance": LPDM_GRAD_REL_L2,
           "k3_launches_two_steps": k_gpu,
           "gen_feature": {"logged": logged, "updated_weights": fresh, "earlier_weights": stale},
           "k3_updated_weights_max_abs_err": k3_err, "k3_tolerance": K3_TOL_SMALL,
           "prefetched_epoch_bit_equal": True}
    emit(row)
    return row


def phase_train_gesture_step(steps: int = 4) -> dict:
    """The LPDM step at the flagship widths of configs/train_gesture.json:
    batch 32 windows of 300 frames, 6D (333 features), prior and denoiser d
    128, ff 512, 9 layers, 4 heads, dropout 0.1, AdamW lr 1e-4, the 50-step
    DDIM monitor every step (K3 at N = 32) and the three vertex forwards on
    a synthetic rig of the SMPL-X sizes (10,475 vertices, the 55-joint tree,
    300 betas; no SMPL-X file is in the repository). Random weights from a
    seed. One warm-up step of each kind, then ``steps`` monitored and
    ``steps`` unmonitored steps timed on CUDA events (device ms and host
    enqueue ms each), K3 counted per step; then the monitored step's pieces
    apart at its shapes: K3 launched alone at N = 32 over this step's
    weights, ``ddim_sample_fused`` as the step calls it (weights and
    conditioning packed afresh), its plain loop, the three vertex forwards;
    last, one monitored step traced."""
    import torch

    from amuse_tpu_torch.core import smplx
    from amuse_tpu_torch.core.motion import featurize
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.ops import denoiser_kernel as dk
    from amuse_tpu_torch.train import gesture as tg
    from amuse_tpu_torch.train.audio import step_generator

    tcfg, prior_cfg, den_cfg = tg.GestureTrainConfig(), PriorConfig(), DenoiserConfig()
    rig = smplx.make_test_model(num_vertices=10475, num_joints=55, num_betas=300,
                                parents=smplx.SMPLX_PARENTS).to("cuda")
    t0 = time.perf_counter()
    state = tg.init_state(0, prior_cfg, den_cfg, tcfg, "cuda")
    steps_fn = {"monitored": tg.make_train_step(prior_cfg, den_cfg, tcfg, rig, True),
                "unmonitored": tg.make_train_step(prior_cfg, den_cfg, tcfg, rig, False)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batch = _lpdm_batch(LPDM_BATCH, prior_cfg.window, den_cfg.cond_dim, 1, torch.device("cuda"))
    watched = {"prior.encoder.input_blocks.0.linear1.weight": state.prior,
               "denoiser.encoder.output_blocks.3.self_attn.in_proj_weight": state.denoiser}
    before = {n: m.get_parameter(n.split(".", 1)[1]).detach().clone() for n, m in watched.items()}
    torch.cuda.reset_peak_memory_stats()
    gen_i = iter(range(10**6))
    for fn in steps_fn.values():  # warm-up
        fn(state, batch, step_generator(0, 0, next(gen_i), "cuda"))
    torch.cuda.synchronize()
    timed = {}
    for kind, fn in steps_fn.items():
        _reset_counts()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        host_ms = []
        events[0].record()
        for i in range(steps):
            h0 = time.perf_counter()
            logs = fn(state, batch, step_generator(0, 0, next(gen_i), "cuda"))
            host_ms.append((time.perf_counter() - h0) * 1e3)
            events[i + 1].record()
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        timed[kind] = {"ms_per_step": sum(step_ms) / steps, "device_ms_each": step_ms,
                       "host_ms_each": host_ms, "k3_launches_per_step": _sampler_launches() / steps,
                       "logs": {k: v.item() for k, v in logs.items()}}
    peak = torch.cuda.max_memory_allocated()
    check(timed["monitored"]["k3_launches_per_step"] == 1
          and timed["unmonitored"]["k3_launches_per_step"] == 0,
          f"K3 launches per step: {timed['monitored']['k3_launches_per_step']} monitored, "
          f"{timed['unmonitored']['k3_launches_per_step']} unmonitored; expected 1 and 0")
    mon = timed["monitored"]["logs"]
    check(all(math.isfinite(v) for v in mon.values()) and "gen_vtex_displacement" in mon,
          f"monitored step logs not finite or incomplete: {mon}")
    moved = {n: (m.get_parameter(n.split(".", 1)[1]).detach() - before[n]).abs().max().item()
             for n, m in watched.items()}
    check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")

    # the monitored step's pieces at its shapes, over the weights as they are
    den, sched, cfg = state.denoiser.eval(), make_schedule(), den_cfg
    con, emo, sty = batch["con"], batch["emo"], batch["sty"]
    x_t = torch.randn((LPDM_BATCH, 1, cfg.latent_dim), generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    pack = dk.pack_for_cluster(dk.pack_denoiser(den), dk.cluster_for(cfg, LPDM_BATCH))
    sched_cond = dk.schedule_conditioning(den, sched, tcfg.num_inference_steps)
    cond = dk.condition_tokens(den, con, emo, sty)

    def kernel():
        return dk.launch_sampler(pack, sched_cond, cond, x_t, cfg)

    def wrapper():  # as the step calls it: weights and conditioning packed afresh
        return dk.ddim_sample_fused(den, sched, con, emo, sty, tcfg.num_inference_steps,
                                    initial_latents=x_t)

    def plain():
        return dk.ddim_sample_reference(den, sched, con, emo, sty, x_t,
                                        tcfg.num_inference_steps)

    k3_err = max_err(kernel(), plain())
    check(torch.equal(kernel(), wrapper()), "K3 launched alone differs from the step's call")
    check(k3_err <= K3_TOL, f"K3 at N = {LPDM_BATCH} vs its plain loop: {k3_err} > {K3_TOL}")
    flops = _sampler_flops(LPDM_BATCH, tcfg.num_inference_steps, 5, cfg.latent_dim, cfg.ff_size,
                           cfg.num_layers)
    nbytes = (sum(t.numel() * 4 for t in dk.pack_denoiser(den))
              + 4.0 * (tcfg.num_inference_steps * (cfg.latent_dim + 4)
                       + LPDM_BATCH * 5 * cfg.latent_dim))
    k3 = {"windows": LPDM_BATCH, "cluster": pack.cluster, "max_abs_err": k3_err,
          "tolerance": K3_TOL, "ms": cuda_ms(kernel, iters=10, warmup=2),
          "wrapper_ms": cuda_ms(wrapper, iters=10, warmup=2),
          "plain_ms": cuda_ms(plain, iters=2, warmup=1),
          "bound_ms": max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
          "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes"}
    soc = smplx.prepare_soc(rig)
    m6 = featurize(batch["motion"])

    def vertices():
        return [smplx.soc_monitor_vertices(rig, soc, m6, batch["betas"]) for _ in range(3)]

    n_frames, v = LPDM_BATCH * prior_cfg.window, rig.num_vertices
    vert_flops = 3 * 2.0 * n_frames * (9 * 54 * 3 * v + 12 * 55 * v)  # the two products
    vert = {"frames": n_frames, "vertices": v, "three_calls_ms": cuda_ms(vertices, iters=3,
                                                                         warmup=1),
            "products_bound_ms": vert_flops / PEAK_F32_FLOPS * 1e3,
            "outputs_gib": 3 * 3 * n_frames * v * 4 / 2**30}
    trace = trace_call(lambda: steps_fn["monitored"](state, batch, step_generator(
        0, 0, next(gen_i), "cuda")), "train_gesture_step")
    with_k3 = [r for r in trace["top"] if "ddim_sampler" in r["kernel"]]
    row = {"phase": "train_gesture_step", "setup_s": setup_s, "batch": LPDM_BATCH,
           "params": sum(p.numel() for m in (state.prior, state.denoiser)
                         for p in m.parameters()),
           "steps": steps, **timed, "peak_mem_gib": peak / 2**30, "param_moved": moved,
           "k3_n32": k3, "vertex_monitors": vert,
           "trace_monitored_step": {**trace, "k3_device_ms": sum(r["ms"] for r in with_k3)}}
    emit(row)
    return row


def _write_smplx_npz(path: Path) -> None:
    """A rig of 40 vertices on the 55-joint SMPL-X tree in the published npz
    layout (posedirs (V, 3, P), ``weights``, ``kintree_table``)."""
    import numpy as np

    from amuse_tpu_torch.core import smplx

    m = smplx.make_test_model(num_vertices=40, num_joints=55, num_betas=10,
                              parents=smplx.SMPLX_PARENTS)
    np.savez(path, v_template=m.v_template.numpy(), shapedirs=m.shapedirs.numpy(),
             posedirs=m.posedirs.numpy().T.reshape(40, 3, -1),
             J_regressor=m.j_regressor.numpy(), weights=m.lbs_weights.numpy(),
             kintree_table=np.stack([m.parents, np.arange(55)]))


def phase_cli_train_gesture(root: Path) -> dict:
    """``--fn prepare_data`` then ``--fn train_gesture`` on the card at tiny
    widths (TINY_CFG; 2 takes x 4 windows, batch 4, the 3-step monitor every
    step, an SMPL-X npz of 40 vertices subsampled to 16): two epochs with a
    checkpoint each; a run of one epoch resumed to two logs the unbroken
    run's epoch-2 losses (rtol 1e-6); K3 launched once per step."""
    import numpy as np

    rng = np.random.default_rng(14)
    for actor_id, name in ((2, "scott"), (9, "miranda")):
        _write_take(root, actor_id, name, "0_9_9", 4, rng)
    (root / "smplx").mkdir()
    _write_smplx_npz(root / "smplx" / "SMPLX_NEUTRAL.npz")
    log = OUT / "cli_train_gesture.log"

    def cfg(work: str, epochs: int) -> str:
        c = dict(TINY_CFG, out_dir=str(root / work / "runs"),
                 gesture={**TINY_CFG["gesture"], "epochs": epochs, "batch_size": 4,
                          "model_save_freq": 1, "vtex_subsample": 16},
                 data={"data_root": str(root / "beat"), "mosh_root": str(root / "mosh"),
                       "cache_dir": str(root / "cache"), "stage1_dataset": str(root / "s1.npz"),
                       "smplx_model_dir": str(root / "smplx")})
        (root / f"{work}.json").write_text(json.dumps(c))
        return str(root / f"{work}.json")

    def train(work: str, epochs: int, *extra) -> dict:
        _run_cli(["--fn", "train_gesture", "--cfg", cfg(work, epochs), *extra], log, root)
        run = sorted((root / work / "runs").iterdir())[-1]
        rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        return {"run": run, "rows": {r["step"]: r for r in rows}}

    t0 = time.perf_counter()
    _run_cli(["--fn", "prepare_data", "--cfg", cfg("prep", 1)], log, root)
    _reset_counts()
    full = train("full", 2)
    k3_launches = _sampler_launches()
    part = train("part", 1)
    resumed = train("resumed", 2, "--set", f"resume={part['run'] / 'checkpoints'}")
    seconds = time.perf_counter() - t0
    ckpts = sorted(p.name for p in (full["run"] / "checkpoints").iterdir())
    check(ckpts == ["step_00000001", "step_00000002"], f"train_gesture checkpoints: {ckpts}")
    check(k3_launches == 4, f"2 epochs of 2 monitored steps launched K3 {k3_launches} times")
    want, got = full["rows"].get(1, {}), resumed["rows"].get(1, {})
    keys = [k for k in want if k.startswith("train_")]
    check(sorted(resumed["rows"]) == [1] and keys and all(
        math.isfinite(want[k]) and abs(got[k] - want[k]) <= 1e-6 * abs(want[k]) for k in keys),
        f"resumed epoch 2 {got} differs from the unbroken run's {want}")
    row = {"phase": "cli_train_gesture", "seconds": seconds, "k3_launches": k3_launches,
           "epoch2": {k: want[k] for k in keys},
           "resumed_max_rel_diff": max(abs(got[k] - want[k]) / abs(want[k]) for k in keys)}
    emit(row)
    return row


def run_train_gesture() -> dict:
    """The three LPDM phases, the CLI's in a temporary directory."""
    rows = {"small": phase_train_gesture_small_vs_cpu(), "step": phase_train_gesture_step()}
    with tempfile.TemporaryDirectory() as tmp:
        rows["cli"] = phase_cli_train_gesture(Path(tmp))
    return rows


# edit and prepare_data paths: the flagship widths, random weights made
# from a seed and written as a released AMUSE directory
EDIT_WINDOWS = 6  # one 60 s take: K1 at (3 x 6, 12, 1214, 64)
PREP_FEAT_TOL = 1e-6  # the cached features against encode_audio on the same batch
CLI_TOL = 1e-3  # the CLIs at tiny widths, card against CPU, float32


def _stage2_name(kind: str, total: float, epoch: int) -> str:
    """The reference's stage-2 checkpoint name (trainer.py:470-496)."""
    return (f"{kind}_recF0.1000_recJ0.2000_kl0.3000_genF0.4000_genJ0.5000_instL0.6000"
            f"_vtexR0.7000_vtexG0.8000_total{total:.4f}_e{epoch}.pt")


def _ast_name(epoch: int, tea: float, tpa: float) -> str:
    """The reference's stage-1 checkpoint name (trainer.py:328)."""
    return (f"model_{epoch}_tL0.50000000_tEA{tea:.8f}_tPA{tpa:.8f}_vL0.60000000"
            f"_vEA0.80000000_vPA0.30000000.pkl")


def write_released_dir(root: Path) -> tuple[dict, dict]:
    """A released AMUSE directory at the flagship widths from the port's
    modules (reference keys, random weights from seed 0): the stage-1
    disentangler with DataParallel ``module.`` prefixes, a prior, a latdiff
    with ``denoiser.`` prefixes in ``model_state_dict``, and decoys whose
    filename metrics must lose (a decoy that is loaded fails).
    -> ({kind: the file to select}, {kind: state dict as written, unprefixed})."""
    import torch

    from amuse_tpu_torch.models.ast import ASTDisentangler
    from amuse_tpu_torch.models.denoiser import Denoiser
    from amuse_tpu_torch.models.vae import MotionPrior

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sds = {"ast": ASTDisentangler().state_dict(), "prior": MotionPrior().state_dict(),
               "denoiser": Denoiser().state_dict()}
    want = {"ast": root / _ast_name(7, 0.91, 0.2),
            "prior": root / _stage2_name("prior_model_NoOpt", 2.0, 200),
            "denoiser": root / _stage2_name("latdiff_model_wOpt", 0.25, 200)}
    torch.save({f"module.{k}": v for k, v in sds["ast"].items()}, want["ast"])
    torch.save(sds["prior"], want["prior"])
    torch.save({"model_state_dict": {f"denoiser.{k}": v for k, v in sds["denoiser"].items()},
                "optimizer_state_dict": {"state": {}, "param_groups": [{"lr": 1e-4}]}},
               want["denoiser"])
    for name in (_ast_name(3, 0.90, 0.95), _stage2_name("prior_model_NoOpt", 0.5, 300),
                 _stage2_name("latdiff_model_wOpt", 0.75, 300)):
        torch.save({"decoy.weight": torch.zeros(3)}, root / name)
    return want, sds


def phase_checkpoint_load(root: Path):
    """A released directory at the flagship widths loaded through
    ``utils/checkpoint_io.py`` (``read_s``: file selection, reading,
    prefixes) into a GesturePipeline on the card (``pipeline_s``: moves,
    the AST stacked, the sampler's weights packed): the files
    the reference's grammars select, every parameter bit-equal to what was
    written, and ``wav_to_motion`` bit-equal to a pipeline built from the same
    state dicts directly, with the same generator. -> the loaded pipeline."""
    import torch

    from amuse_tpu_torch.infer.pipeline import ENCODERS, GesturePipeline, PipelineParams
    from amuse_tpu_torch.utils import checkpoint_io

    t0 = time.perf_counter()
    want, sds = write_released_dir(root)
    write_s = time.perf_counter() - t0
    os.environ["AMUSE_TPU_CKPT"] = str(root)
    try:
        t0 = time.perf_counter()
        params = checkpoint_io.load_pipeline_params()
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipe = GesturePipeline(params, device="cuda")
        torch.cuda.synchronize()
        pipeline_s = time.perf_counter() - t0
    finally:
        del os.environ["AMUSE_TPU_CKPT"]
    selected = checkpoint_io.released_files(root)
    check(selected == want, f"checkpoint_io selected {selected}, expected {want}")
    n_params = 0
    for kind in ("ast", "prior", "denoiser"):
        got = getattr(params, kind)
        check(got.keys() == sds[kind].keys(), f"loaded {kind} keys differ from those written")
        for k, v in sds[kind].items():
            check(torch.equal(got[k], v), f"loaded {kind} parameter {k} differs")
            n_params += v.numel()
    for kind, module in (("prior", pipe.prior), ("denoiser", pipe.denoiser)):
        for k, v in module.state_dict().items():
            check(torch.equal(v.cpu(), sds[kind][k]), f"pipeline {kind} parameter {k} differs")
    for k, v in pipe.ast_params.items():
        ref = torch.stack([sds["ast"][f"{n}_enc.{k}"] for n in ENCODERS]).to(pipe.dtype)
        check(torch.equal(v.cpu(), ref), f"pipeline AST parameter {k} differs")
    direct = GesturePipeline(PipelineParams(**sds), device="cuda")
    chunks = _chunks(2, 7)
    outs = [p.wav_to_motion(chunks, generator=torch.Generator(device="cuda").manual_seed(0))
            for p in (pipe, direct)]
    check(all(torch.equal(a, b) for a, b in zip(*outs)),
          "wav_to_motion of the loaded pipeline differs from one built from the state dicts")
    check(all(torch.isfinite(t).all().item() for t in outs[0]), "wav_to_motion not finite")
    del direct
    emit({"phase": "checkpoint_load", "selected": {k: v.name for k, v in selected.items()},
          "parameters": n_params, "write_s": write_s, "read_s": read_s,
          "pipeline_s": pipeline_s, "load_s": read_s + pipeline_s,
          "wav_to_motion_bit_equal": True})
    return pipe


def _write_take(root: Path, actor_id: int, name: str, take: str, windows: int, rng) -> None:
    """A BEAT take (wav, emotion CSV) and its MoSh npz (30 fps), 0.1 s over
    ``windows`` 10 s windows."""
    import numpy as np

    from amuse_tpu_torch.audio.wavio import save_wav

    d = root / "beat" / str(actor_id)
    d.mkdir(parents=True, exist_ok=True)
    (root / "mosh").mkdir(exist_ok=True)
    stem = f"{actor_id}_{name}_{take}"
    save_wav(d / f"{stem}.wav",
             rng.normal(scale=0.05, size=windows * 160000 + 1600).astype(np.float32))
    (d / f"{stem}.csv").write_text("0,0\n1,0\n")
    t = windows * 300 + 3
    np.savez(root / "mosh" / f"{stem}.npz",
             poses=(0.2 * rng.normal(size=(t, 165))).astype(np.float32),
             trans=(0.1 * rng.normal(size=(t, 3))).astype(np.float32))


def phase_edit(pipe, root: Path) -> dict:
    """emotion_control through ``pipe`` over one actor's 8 emotion takes of
    EDIT_WINDOWS windows with motion (8 encode_take: 96 K1; 64 generate_with:
    64 K3 at N = EDIT_WINDOWS, counted exactly), "self" bit-equal to a
    variant given the source's own emotion latent, then style_transfer with
    reference_quirk True and False on two takes, which must differ."""
    import numpy as np
    import torch

    from amuse_tpu_torch.data import beat, eval_sets
    from amuse_tpu_torch.data.actors import PRETRAINED_TAKES
    from amuse_tpu_torch.infer import editing

    rng = np.random.default_rng(9)
    for first, _ in PRETRAINED_TAKES.values():
        _write_take(root, 2, "scott", first, EDIT_WINDOWS, rng)
    items = eval_sets.emotion_control_set(beat.discover(root / "beat", root / "mosh"), "scott")
    check(len(items) == 8, f"{len(items)} emotion takes found, expected 8")
    editing.generate_with(pipe, *(torch.zeros((EDIT_WINDOWS, pipe.denoiser_cfg.cond_dim),
                                              device="cuda") for _ in range(3)))  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    latents = [editing.encode_take(pipe, i.actor, i.take, 0, i.waveform, i.motion, seed=1)
               for i in items]
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = editing.emotion_control(pipe, latents, seed=1)
    control_s = time.perf_counter() - t0
    counts = _launch_counts() | {"ddim_sampler": _sampler_launches()}
    variants = sum(len(v) for v in out.values())
    want = {"attention_fwd": 8 * pipe.ast_cfg.depth, "attention_bwd": 0, "ddim_sampler": 64}
    check(variants == 64 and counts == want,
          f"emotion_control launched {counts} for {variants} variants, expected {want}")
    for source in out.values():
        for poses, trans in source.values():
            check(poses.shape == (EDIT_WINDOWS, 300, 55, 3) and np.isfinite(poses).all()
                  and np.isfinite(trans).all(), "emotion_control output bad")
    src = latents[0]
    again = editing.generate_with(pipe, src.con, src.emo, src.sty, seed=1)
    check(all(np.array_equal(a, b) for a, b in zip(out[f"scott_{src.take}"]["self"], again)),
          "a variant with the source's own emotion latent differs from 'self'")
    style, style_s = {}, {}
    for quirk in ("quirk", "straight"):
        t0 = time.perf_counter()
        style[quirk] = editing.style_transfer(pipe, latents[:1], latents[1:2], seed=1,
                                              reference_quirk=quirk == "quirk")
        style_s[quirk] = time.perf_counter() - t0
    key = f"scott_{latents[0].take}"
    check(not np.allclose(style["quirk"][key]["sty_scott"][0],
                          style["straight"][key]["sty_scott"][0]),
          "style_transfer with and without the reference quirk agree")
    emit({"phase": "trace_edit", "windows": EDIT_WINDOWS,
          "encode_take": trace_call(lambda: editing.encode_take(
              pipe, src.actor, src.take, 0, items[0].waveform, items[0].motion, seed=1),
              "encode_take"),
          "generate_with": trace_call(lambda: editing.generate_with(
              pipe, src.con, src.emo, src.sty, seed=1), "generate_with")})
    row = {"phase": "edit_gesture", "takes": len(items), "windows_per_take": EDIT_WINDOWS,
           "launches": counts, "variants": variants, "encode_s": encode_s,
           "emotion_control_s": control_s,
           "ms_per_generated_window": control_s * 1e3 / (variants * EDIT_WINDOWS),
           "style_transfer_s": style_s,
           "self_bit_equal": True}
    emit(row)
    return row


def _sampler_launches() -> int:
    from amuse_tpu_torch.ops import denoiser_kernel

    return denoiser_kernel.ddim_sample_fused.launches


def phase_prepare_data(pipe, root: Path) -> dict:
    """The stage-2 cache and stage-1 quads on the card, through ``pipe``'s
    flagship AST: 2 actors x the two neutral takes x EDIT_WINDOWS windows.
    Checks the manifest (24 windows), 12 K1 launches per take, one take's
    cached features against encode_audio on the same chunks, and the quad
    count; times the frozen-AST pass alone and the whole build."""
    import numpy as np
    import torch

    from amuse_tpu_torch.audio import fbank
    from amuse_tpu_torch.audio.wavio import load_wav_resampled
    from amuse_tpu_torch.data import beat, cache, stage1

    rng = np.random.default_rng(10)
    for actor_id, name in ((2, "scott"), (9, "miranda")):
        for take in ("0_9_9", "0_10_10"):
            _write_take(root, actor_id, name, take, EDIT_WINDOWS, rng)
    takes = beat.discover(root / "beat", root / "mosh")
    subset = beat.stage2_subset(takes)
    encode_s = []

    def encode(chunks):
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in pipe.encode_audio(chunks).items()}
        encode_s.append(time.perf_counter() - t0)
        return out

    pipe.encode_audio(_chunks(EDIT_WINDOWS, 11))  # warm-up at the take's batch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    cache.build_stage2_cache(subset, root / "cache", encode, ast_source="chip_smoke",
                             progress=False)
    build_s = time.perf_counter() - t0
    counts = _launch_counts()
    depth = pipe.ast_cfg.depth
    check(counts == {"attention_fwd": depth * len(subset), "attention_bwd": 0},
          f"the stage-2 pass launched {counts} for {len(subset)} takes, expected "
          f"{depth} K1 per take")
    manifest = json.loads((root / "cache" / "manifest.json").read_text())
    check(len(subset) == 4 and manifest["num_windows"] == 4 * EDIT_WINDOWS,
          f"manifest holds {manifest['num_windows']} windows of {len(subset)} takes, "
          f"expected {4 * EDIT_WINDOWS}")
    wc = cache.WindowCache(root / "cache")
    ref = pipe.encode_audio(fbank.window_waveform(load_wav_resampled(subset[0].wav)))
    feat_err = max(float(np.abs(np.stack([wc[i][k] for i in range(EDIT_WINDOWS)])
                                - ref[k].cpu().numpy()).max()) for k in ("con", "emo", "sty"))
    check(feat_err <= PREP_FEAT_TOL, f"cached features differ from encode_audio on the same "
                                     f"chunks by {feat_err} > {PREP_FEAT_TOL}")
    t0 = time.perf_counter()
    per_take = stage1.fbanks_per_take(takes, fbank.make_sharded_fbank(None, "cuda"))
    train = stage1.build_quads(per_take, "train")
    stage1_s = time.perf_counter() - t0
    check(train["emo_id"].shape[0] == EDIT_WINDOWS and train["fbank_bank"].shape
          == (4 * EDIT_WINDOWS, 1024, 128) and np.isfinite(train["fbank_bank"]).all(),
          f"stage-1 quads: {train['emo_id'].shape[0]}, expected {EDIT_WINDOWS}")
    row = {"phase": "prepare_data", "takes": len(subset), "windows": manifest["num_windows"],
           "launches": counts, "feature_max_abs_err": feat_err, "feature_tolerance": PREP_FEAT_TOL,
           "ast_s": sum(encode_s), "ast_windows_per_s": manifest["num_windows"] / sum(encode_s),
           "build_s": build_s, "build_s_per_take": build_s / len(subset),
           "stage1_quads": int(train["emo_id"].shape[0]), "stage1_s": stage1_s}
    emit(row)
    return row


# the tiny widths of the CPU drives, but the AST 64 wide: K1 takes head dims 32 and 64
TINY_CFG = {"audio": {"ast_embed_dim": 64, "ast_depth": 1, "ast_heads": 2, "ast_feature_dim": 12},
            "gesture": {"latent_dim": 16, "ff_size": 32, "num_layers": 3, "num_heads": 2,
                        "cond_dim": 12, "num_inference_steps": 3},
            "dtype": "float32"}


def _run_cli(argv: list, log: Path, cwd: Path) -> None:
    """The port's CLI in this process (stdout to ``log``), with the initial
    DDIM latents drawn from a CPU generator seeded with the seed the CLI
    gave: CUDA's and the CPU's generators draw different numbers, and this
    is the only difference the card-against-CPU comparison must not see."""
    import contextlib

    import torch

    from amuse_tpu_torch.cli import main as cli
    from amuse_tpu_torch.infer.pipeline import GesturePipeline

    plain = GesturePipeline.generate_latents

    def same_noise(self, con, emo=None, sty=None, generator=None, initial_latents=None):
        shape = (con.shape[0], self.denoiser_cfg.latent_tokens, self.denoiser_cfg.latent_dim)
        x0 = torch.randn(shape, generator=torch.Generator().manual_seed(generator.initial_seed()))
        return plain(self, con, emo, sty, initial_latents=x0)

    here = Path.cwd()
    GesturePipeline.generate_latents = same_noise
    try:
        os.chdir(cwd)
        with open(log, "a") as f, contextlib.redirect_stdout(f):
            cli.main(argv)
    finally:
        os.chdir(here)
        GesturePipeline.generate_latents = plain


def phase_cli_edit_prepare(root: Path) -> dict:
    """``--fn edit_gesture`` (emotion_control over two takes and the demo
    swap, 2 windows each) and ``--fn prepare_data`` (5 takes, 10 windows, 2
    stage-1 quads) at tiny widths (TINY_CFG), on the card and with
    ``--device cpu``: the npz poses (as rotation matrices) and trans, the
    cached features and the stage-1 fbanks within CLI_TOL; motion, audio and
    labels of the caches bit-equal."""
    import numpy as np
    import torch

    from amuse_tpu_torch.audio.wavio import save_wav
    from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
    from amuse_tpu_torch.data import cache, stage1

    rng = np.random.default_rng(12)
    for actor_id, name, take in ((2, "scott", "0_9_9"), (2, "scott", "0_10_10"),
                                 (2, "scott", "0_65_65"), (9, "miranda", "0_9_9"),
                                 (9, "miranda", "0_10_10")):
        _write_take(root, actor_id, name, take, 2, rng)
    demo = root / "viz_dump" / "test" / "e_speech"
    demo.mkdir(parents=True)
    for name in ("source_neutral.wav", "target_happy.wav"):
        save_wav(demo / name, rng.normal(scale=0.05, size=330000).astype(np.float32))
    env_ckpt = os.environ.pop("AMUSE_TPU_CKPT", None)
    seconds, errs = {}, {"poses": 0.0, "trans": 0.0, "features": 0.0, "fbanks": 0.0}
    try:
        for device in ("cuda", "cpu"):
            cfg = dict(TINY_CFG, out_dir=str(root / device / "runs"),
                       data={"data_root": str(root / "beat"), "mosh_root": str(root / "mosh"),
                             "cache_dir": str(root / device / "cache"),
                             "stage1_dataset": str(root / device / "stage1.npz")},
                       test={"emotion_control": True, "actors": ["scott"]})
            (root / f"{device}.json").write_text(json.dumps(cfg))
            for fn in ("edit_gesture", "prepare_data"):
                t0 = time.perf_counter()
                _run_cli(["--fn", fn, "--cfg", str(root / f"{device}.json"), "--device", device],
                         OUT / f"cli_{fn}.log", root)
                seconds[f"{fn}_{device}"] = time.perf_counter() - t0
    finally:
        if env_ckpt is not None:
            os.environ["AMUSE_TPU_CKPT"] = env_ckpt
    (gpu_run,), (cpu_run,) = ((root / d / "runs").iterdir() for d in ("cuda", "cpu"))
    files = sorted(p.relative_to(gpu_run) for p in gpu_run.rglob("*.npz"))
    check(len(files) == 2 * 2 * 2 + 2 * 2 and files == sorted(
        p.relative_to(cpu_run) for p in cpu_run.rglob("*.npz")),
        f"edit_gesture CLI wrote {len(files)} npz files on the card, not the CPU's 12")
    for rel in files:
        a, b = np.load(gpu_run / rel), np.load(cpu_run / rel)
        errs["trans"] = max(errs["trans"], float(np.abs(a["trans"] - b["trans"]).max()))
        rot = [axis_angle_to_matrix(torch.from_numpy(d["poses"])) for d in (a, b)]
        errs["poses"] = max(errs["poses"], max_err(*rot))
    gpu_cache, cpu_cache = (cache.WindowCache(root / d / "cache") for d in ("cuda", "cpu"))
    check(len(gpu_cache) == len(cpu_cache) == 10, "prepare_data CLI caches hold other counts")
    for i in range(len(gpu_cache)):
        a, b = gpu_cache[i], cpu_cache[i]
        for f in ("motion", "actor_id", "emo_label", "audio"):
            check(np.array_equal(a[f], b[f]), f"cached {f} differs between card and CPU")
        errs["features"] = max(errs["features"], max(float(np.abs(a[k] - b[k]).max())
                                                     for k in ("con", "emo", "sty")))
    (gpu_train, _), (cpu_train, _) = (stage1.load_dataset(root / d / "stage1.npz")
                                      for d in ("cuda", "cpu"))
    check(np.array_equal(gpu_train["quad_idx"], cpu_train["quad_idx"]), "quads differ")
    errs["fbanks"] = float(np.abs(gpu_train["fbank_bank"] - cpu_train["fbank_bank"]).max())
    check(all(e <= CLI_TOL for e in errs.values()),
          f"the CLIs on the card disagree with the CPU: {errs} > {CLI_TOL}")
    row = {"phase": "cli_edit_gesture_prepare_data", "npz_files": len(files),
           "max_abs_err": errs, "tolerance": CLI_TOL, "seconds": seconds}
    emit(row)
    return row


def run_edit_and_prepare(only: str | None = None, with_prepare: bool = False) -> dict:
    """checkpoint_load, edit_gesture, prepare_data (through the loaded
    flagship pipeline) and the CLIs; ``only="edit"`` runs the first two
    (and prepare_data ``with_prepare``), ``only="prepare"`` prepare_data
    alone through random flagship weights. Each in a temporary directory."""
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if only != "prepare":
            (tmp / "released").mkdir()
            pipe = phase_checkpoint_load(tmp / "released")
            rows["edit"] = phase_edit(pipe, tmp / "edit")
        else:
            pipe = GesturePipeline(init_random_params(0), device="cuda")
        if only != "edit" or with_prepare:
            rows["prepare"] = phase_prepare_data(pipe, tmp / "prepare")
        del pipe
        if only is None:
            rows["cli"] = phase_cli_edit_prepare(tmp / "cli")
    return rows


# evaluation, the external embedder and the native ABIN loader
EVAL_WINDOWS = 100  # batch 32: K3 at N = 32, 32, 32 and the tail 4
EVAL_BATCH = 32
EVAL_RTOL = 1e-3  # the small-width report, card against CPU, every numeric key
EMB_LOSS_RTOL = 1e-5  # the small-width embedder step, card against CPU
EMB_GRAD_REL_L2 = 1e-5
EMB_BATCH = 32
NATIVE_WINDOWS = 512
LPDM_FIELDS = ("motion", "actor_id", "con", "emo", "sty")


def _burst_audio(rng, samples: int, offset: int):
    """Silence with loud 40 ms bursts every 0.33 s: onsets far above the
    peak picker's threshold, so the card's and the CPU's fbanks find the
    same beats."""
    import numpy as np

    audio = np.zeros(samples, np.float32)
    for s in range(500 + offset, samples - 640, 5300):
        audio[s:s + 640] = 0.3 * rng.normal(size=640)
    return audio


def _write_cache(root: Path, n: int, cond_dim: int, seed: int, audio: bool = True) -> Path:
    """A stage-2 window cache of ``n`` windows in the cache layout (shards
    of ``SHARD_WINDOWS``, a manifest): random axis-angle motion and
    features, actors whose betas the repository has, and 10 s of burst
    audio per window (``audio``) or an
    unwritten (sparse) zero audio column, which ``batches`` never reads."""
    import numpy as np

    from amuse_tpu_torch.data.actors import ACTORS, _load_betas
    from amuse_tpu_torch.data.cache import FIELDS, SHARD_WINDOWS

    rng = np.random.default_rng(seed)
    with_betas = np.array([i - 1 for i, a in ACTORS.items() if a.name in _load_betas()])
    shards = []
    for s, start in enumerate(range(0, n, SHARD_WINDOWS)):
        m = min(SHARD_WINDOWS, n - start)
        d = root / f"shard_{s:05d}"
        d.mkdir(parents=True)
        np.save(d / "motion.npy", (0.2 * rng.normal(size=(m, 300, 168))).astype(np.float32))
        np.save(d / "actor_id.npy",
                with_betas[(start + np.arange(m)) % with_betas.size].astype(np.int32))
        np.save(d / "emo_label.npy", np.zeros(m, np.int32))
        for k in ("con", "emo", "sty"):
            np.save(d / f"{k}.npy", rng.normal(size=(m, cond_dim)).astype(np.float32))
        col = np.lib.format.open_memmap(d / "audio.npy", mode="w+", dtype=np.float32,
                                        shape=(m, 160000))
        if audio:
            for i in range(m):
                col[i] = _burst_audio(rng, 160000, 37 * (start + i) % 5000)
        col.flush()
        del col
        shards.append(d.name)
    (root / "manifest.json").write_text(json.dumps(
        {"num_windows": n, "shards": shards, "fields": list(FIELDS), "ast_source": "chip_smoke"}))
    return root


def _eval_small_vs_cpu(root: Path) -> dict:
    """The eval at small widths (prior and denoiser d 32, 10 DDIM steps), 10
    windows at batch 4 (K3 at N = 4, 4, 2), in position space on a 40-vertex
    rig of the SMPL-X tree, with the committed embedder, on the card and on
    the CPU: every numeric key within EVAL_RTOL, the labels and R-precision
    counts equal, the audio beats of the card's fbank equal to the CPU's."""
    import numpy as np
    import torch

    from amuse_tpu_torch.core import smplx
    from amuse_tpu_torch.data.cache import WindowCache
    from amuse_tpu_torch.eval import embedder as emb
    from amuse_tpu_torch.eval import runner
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig

    cfgs = (PriorConfig(**{k: v for k, v in SMALL_PRIOR.items() if k != "window"}),
            DenoiserConfig(**SMALL_DENOISER), ASTConfig(**SMALL_AST))
    params = init_random_params(7, *cfgs)
    cache = WindowCache(_write_cache(root, 10, SMALL_DENOISER["cond_dim"], seed=5))
    rig = smplx.make_test_model(num_vertices=40, num_joints=55, num_betas=10,
                                parents=smplx.SMPLX_PARENTS)
    reports, launches = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = GesturePipeline(params, *cfgs, dtype=torch.float32, num_inference_steps=10,
                               device=dev)
        before = _sampler_launches()
        reports[dev] = runner.evaluate_cache(pipe, cache, batch_size=4, seed=3,
                                             smplx_model=rig.to(dev),
                                             embedder=emb.load(emb.DEFAULT_WEIGHTS))
        launches[dev] = _sampler_launches() - before
    cpu, gpu = reports["cpu"], reports["cuda"]
    check(launches == {"cpu": 0, "cuda": 3}, f"small eval K3 launches {launches}")
    check(gpu.keys() == cpu.keys() and gpu["metric_space"] == "position",
          f"small eval report keys differ: {sorted(gpu)} vs {sorted(cpu)}")
    rel = {}
    for k, v in cpu.items():
        if isinstance(v, str) or k.startswith("r_precision_top"):
            check(gpu[k] == v, f"small eval {k}: card {gpu[k]!r}, CPU {v!r}")
        else:
            rel[k] = abs(gpu[k] - v) / max(abs(v), 1e-3)
    check(all(r <= EVAL_RTOL for r in rel.values()),
          f"small eval on the card vs the CPU: {rel} > {EVAL_RTOL}")
    waves = np.stack([cache[i]["audio"] for i in range(len(cache))])
    beats = [runner.audio_beats(waves, d) for d in ("cuda", "cpu")]
    counts = [int(b.size) for b in beats[0]]
    check(all(np.array_equal(a, b) for a, b in zip(*beats)) and min(counts) >= 20,
          f"audio beats on the card differ from the CPU's (counts {counts})")
    return {"max_rel_diff": max(rel.values()), "worst_key": max(rel, key=rel.get),
            "tolerance": EVAL_RTOL, "k3_launches": launches["cuda"], "beats_per_window": counts,
            "report_cuda": {k: v for k, v in gpu.items() if not isinstance(v, str)}}


def phase_eval_gesture(root: Path) -> dict:
    """``evaluate_cache`` at the flagship widths (random weights; denoiser d
    128 x 9 layers, the VAE over 300 frames, 50 DDIM steps) over a cache of
    EVAL_WINDOWS windows with 10 s of audio each, at batch 32, in position
    space on a synthetic rig of the SMPL-X sizes (10,475 vertices, the
    55-joint tree, 300 betas), with the committed embedder. A warm-up over 36
    windows, then the counted and timed run: K3 launched 4 times (N = 32,
    32, 32, 4), no K1 or K2; a second timed run gives the same report. Then
    the pieces at their shapes: K3 at the tail
    N = 4 alone, as the pipeline calls it, and its plain loop; FK, the
    embedder and the fbank of the beat detector (device ms), the peak
    picking (host ms); one batch traced; the small-width gate."""
    import numpy as np
    import torch

    from amuse_tpu_torch.audio import fbank
    from amuse_tpu_torch.core import motion as motion_mod
    from amuse_tpu_torch.core import smplx
    from amuse_tpu_torch.data.cache import WindowCache, betas_for_actor_ids
    from amuse_tpu_torch.eval import embedder as emb
    from amuse_tpu_torch.eval import metrics as M
    from amuse_tpu_torch.eval import runner
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    t0 = time.perf_counter()
    pipe = GesturePipeline(init_random_params(0), device="cuda")
    cache = WindowCache(_write_cache(root / "cache", EVAL_WINDOWS,
                                     pipe.denoiser_cfg.cond_dim, seed=4))
    rig = smplx.make_test_model(num_vertices=10475, num_joints=55, num_betas=300,
                                parents=smplx.SMPLX_PARENTS).to("cuda")
    embedder = emb.load(emb.DEFAULT_WEIGHTS)
    setup_s = time.perf_counter() - t0

    def run(n: int) -> dict:
        return runner.evaluate_cache(pipe, cache, max_windows=n, batch_size=EVAL_BATCH, seed=0,
                                     smplx_model=rig, embedder=embedder)

    run(36)  # warm-up: both batch shapes
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    report = run(EVAL_WINDOWS)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    k3_launches = _sampler_launches()
    counts = _launch_counts()
    t0 = time.perf_counter()
    check(run(EVAL_WINDOWS) == report, "a second eval of the same cache differs")
    torch.cuda.synchronize()
    eval_again_s = time.perf_counter() - t0
    check(k3_launches == -(-EVAL_WINDOWS // EVAL_BATCH) and counts == {
        "attention_fwd": 0, "attention_bwd": 0},
        f"the eval launched K3 {k3_launches} times and {counts}, expected "
        f"{-(-EVAL_WINDOWS // EVAL_BATCH)} and no attention")
    numbers = {k: v for k, v in report.items() if not isinstance(v, str)}
    check(report["num_windows"] == EVAL_WINDOWS and report["metric_space"] == "position"
          and "fgd_embedder" in report and "beat_align_gen" in report
          and all(math.isfinite(v) for v in numbers.values()),
          f"eval report incomplete or not finite: {report}")

    # K3 at the tail N = 4, over the pipeline's packed weights
    den, cfg, tail = pipe.denoiser, pipe.denoiser_cfg, EVAL_WINDOWS % EVAL_BATCH
    start = EVAL_WINDOWS - tail
    con, emo, sty = (torch.as_tensor(np.stack([cache[i][k] for i in range(start, EVAL_WINDOWS)]))
                     .cuda() for k in ("con", "emo", "sty"))
    x0 = runner.batch_latents(0, start, (tail, 1, cfg.latent_dim)).cuda()
    pack = pipe.sampler_weights.for_cluster(dk.cluster_for(cfg, tail))
    cond = dk.condition_tokens(den, con, emo, sty)
    steps = pipe.num_inference_steps

    def kernel():
        return dk.launch_sampler(pack, pipe.sampler_conditioning, cond, x0, cfg)

    def plain():
        return dk.ddim_sample_reference(den, pipe.schedule, con, emo, sty, x0, steps)

    out = kernel()
    k3_err = max_err(out, plain())
    check(torch.equal(pipe.generate_latents(con, emo, sty, initial_latents=x0), out),
          "K3 launched alone differs from the eval's call at the tail")
    check(k3_err <= K3_TOL, f"K3 at the tail N = {tail} vs its plain loop: {k3_err} > {K3_TOL}")
    flops = _sampler_flops(tail, steps, 5, cfg.latent_dim, cfg.ff_size, cfg.num_layers)
    nbytes = (sum(t.numel() * 4 for t in dk.pack_denoiser(den))
              + 4.0 * (steps * (cfg.latent_dim + 4) + tail * 5 * cfg.latent_dim))
    k3 = {"windows": tail, "cluster": pack.cluster, "max_abs_err": k3_err, "tolerance": K3_TOL,
          "ms": cuda_ms(kernel, iters=10, warmup=2),
          "wrapper_ms": cuda_ms(lambda: pipe.generate_latents(con, emo, sty, initial_latents=x0),
                                iters=10, warmup=2),
          "plain_ms": cuda_ms(plain, iters=2, warmup=1),
          "bound_ms": max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
          "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes"}

    # the other device pieces of one batch of 32, at their shapes
    items = [cache[i] for i in range(EVAL_BATCH)]
    motion = torch.as_tensor(np.stack([it["motion"] for it in items])).cuda()
    m6 = motion_mod.axis_angle_to_feats6d(motion)
    aa, tr = motion_mod.feats6d_to_axis_angle(m6)
    betas = torch.from_numpy(betas_for_actor_ids(np.stack([it["actor_id"] for it in items])))
    betas = betas.cuda()
    fk, model = runner.make_fk(rig), emb.make_model(embedder[0], embedder[1], "cuda").eval()
    waves = torch.as_tensor(np.stack([it["audio"] for it in items])).cuda()
    mel = fbank.fbank(waves).cpu().numpy()
    t0 = time.perf_counter()
    for m in mel:
        M.audio_beats_from_mel(m)
    peak_ms = (time.perf_counter() - t0) * 1e3
    aa_np = aa.cpu().numpy()
    t0 = time.perf_counter()
    for j in aa_np:
        M.motion_beats_from_joints(j)
    motion_beats_ms = (time.perf_counter() - t0) * 1e3
    pieces = {"fk_ms": cuda_ms(lambda: fk(aa, tr, betas), iters=5, warmup=1),
              "embedder_ms": cuda_ms(lambda: emb.embed(model, m6), iters=10, warmup=2),
              "fbank_ms": cuda_ms(lambda: fbank.fbank(waves), iters=10, warmup=2),
              "peak_picking_host_ms": peak_ms, "motion_beats_host_ms": motion_beats_ms,
              "fk_frames": EVAL_BATCH * 300, "windows": EVAL_BATCH}
    trace = trace_call(lambda: run(EVAL_BATCH), "eval_batch")
    k3_n32_ms = sum(r["ms"] for r in trace["top"] if "ddim_sampler" in r["kernel"])
    # K3's device time in the timed run: three launches at N = 32 (as traced)
    # and the tail's, over the run's wall time
    k3_eval_ms = (EVAL_WINDOWS // EVAL_BATCH) * k3_n32_ms + k3["ms"]
    small = _eval_small_vs_cpu(root / "small")
    row = {"phase": "eval_gesture", "windows": EVAL_WINDOWS, "batch": EVAL_BATCH,
           "setup_s": setup_s, "eval_s": eval_s, "ms_per_window": eval_s * 1e3 / EVAL_WINDOWS,
           "eval_again_s": eval_again_s,
           "k3_launches": k3_launches, "launches": counts, "report": numbers,
           "k3_tail": k3, "k3_eval_ms": k3_eval_ms, "k3_share": k3_eval_ms / (eval_s * 1e3),
           "pieces": pieces, "trace_one_batch": {**trace, "k3_device_ms": k3_n32_ms},
           "small_vs_cpu": small}
    emit(row)
    return row


def phase_train_embedder() -> dict:
    """The embedder's step at the committed weights' widths (in 333, T 300,
    channels 128/64, latent 64) at batch EMB_BATCH: 3 warm-up steps, 20
    timed on CUDA events (device ms and host enqueue ms each), peak memory;
    then the small-width gate: one step's loss and gradients on the card
    against the CPU (EMB_LOSS_RTOL, EMB_GRAD_REL_L2)."""
    import numpy as np
    import torch

    from amuse_tpu_torch.core.motion import axis_angle_to_feats6d
    from amuse_tpu_torch.eval import embedder as emb

    _, cfg, _ = emb.load(emb.DEFAULT_WEIGHTS)
    model = emb.make_model(emb.init_params(0, cfg), cfg, "cuda")
    step, _ = emb.make_train_step(model, 1e-3)
    rng = np.random.default_rng(3)
    batch = axis_angle_to_feats6d(torch.as_tensor(
        (0.2 * rng.normal(size=(EMB_BATCH, cfg.window, 168))).astype(np.float32)).cuda())
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 20
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host_ms = []
    events[0].record()
    losses = []
    for i in range(n):
        h0 = time.perf_counter()
        losses.append(step(batch))
        host_ms.append((time.perf_counter() - h0) * 1e3)
        events[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [v.item() for v in losses]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"embedder losses did not fall: {losses[0]} -> {losses[-1]}")

    small = emb.EmbedderConfig(in_dim=333, window=30, channels=(16, 8), latent_dim=8)
    params = emb.init_params(1, small)
    x = torch.as_tensor(rng.normal(scale=0.3, size=(4, 30, 333)).astype(np.float32))
    got = {}
    for dev in ("cpu", "cuda"):
        m = emb.make_model(params, small, dev)
        _, rec = m(x.to(dev))
        loss = torch.mean((rec - x.to(dev)) ** 2)
        loss.backward()
        got[dev] = (loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()})
    (l_c, g_c), (l_g, g_g) = got["cpu"], got["cuda"]
    loss_rel = abs(l_g - l_c) / abs(l_c)
    grad_rel = (sum(((g_g[k] - g) ** 2).sum() for k, g in g_c.items()).sqrt()
                / sum((g ** 2).sum() for g in g_c.values()).sqrt()).item()
    check(loss_rel <= EMB_LOSS_RTOL and grad_rel <= EMB_GRAD_REL_L2,
          f"embedder step on the card vs the CPU: loss {loss_rel} (limit {EMB_LOSS_RTOL}), "
          f"gradients {grad_rel} (limit {EMB_GRAD_REL_L2})")
    row = {"phase": "train_embedder", "batch": EMB_BATCH, "window": cfg.window,
           "channels": list(cfg.channels), "latent_dim": cfg.latent_dim, "steps": n,
           "ms_per_step": sum(step_ms) / n, "device_ms_each": step_ms,
           "host_enqueue_ms_mean": sum(host_ms) / n,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "loss_first_last": [losses[0], losses[-1]],
           "small_vs_cpu": {"loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                            "tolerance": [EMB_LOSS_RTOL, EMB_GRAD_REL_L2]}}
    emit(row)
    return row


def phase_native_loader(root: Path) -> dict:
    """A cache of NATIVE_WINDOWS windows (2 shards) turned into an ABIN file
    of the LPDM fields by ``cache_to_abin``; windows per second of an epoch
    at batch 32 through the pinned prefetch onto the card, from
    ``NativeWindowLoader.epoch`` and from ``WindowCache.batches``, three
    epochs each in turns after a warm-up; an epoch on the card bit-equal to
    the loader's host batches of the same seed; the unmonitored flagship
    LPDM step at batch 32 fed by each loader (6 steps after a warm-up, twice
    each, in turns); then the train_gesture CLI with the native loader on
    the card."""
    import numpy as np
    import torch

    from amuse_tpu_torch.data.cache import WindowCache, betas_for_actor_ids
    from amuse_tpu_torch.data.prefetch import prefetch_to_device
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.native import loader
    from amuse_tpu_torch.train import gesture as tg
    from amuse_tpu_torch.train.audio import step_generator

    cache_dir = _write_cache(root / "cache", NATIVE_WINDOWS, 256, seed=6, audio=False)
    t0 = time.perf_counter()
    abin = loader.cache_to_abin(cache_dir, root / "train.abin", fields=LPDM_FIELDS)
    abin_s = time.perf_counter() - t0
    ld, wc = loader.NativeWindowLoader(abin), WindowCache(cache_dir)

    def native_epoch(seed):
        return ld.epoch(LPDM_BATCH, seed=seed)

    def cache_epoch(seed):
        return wc.batches(LPDM_BATCH, np.random.default_rng(seed))

    feeds = {"native": native_epoch, "window_cache": cache_epoch}
    rates = {name: [] for name in feeds}
    for rep in range(4):  # in turns, each order twice; rep 0 warms the page cache
        for name in (list(feeds) if rep % 2 else list(feeds)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = sum(b["motion"].shape[0] for b in prefetch_to_device(feeds[name](rep), 2, "cuda"))
            torch.cuda.synchronize()
            if rep:
                rates[name].append(n / (time.perf_counter() - t0))
    got = [{k: v.cpu() for k, v in b.items()}
           for b in prefetch_to_device(native_epoch(11), 2, "cuda")]
    want = list(native_epoch(11))
    check(len(got) == len(want) == NATIVE_WINDOWS // LPDM_BATCH and all(
        a.keys() == b.keys() and all(torch.equal(a[k], torch.from_numpy(b[k])) for k in b)
        for a, b in zip(got, want)), "the native loader's batches on the card differ from "
                                     "its host batches")

    prior_cfg, den_cfg, tcfg = PriorConfig(), DenoiserConfig(), tg.GestureTrainConfig()
    state = tg.init_state(0, prior_cfg, den_cfg, tcfg, "cuda")
    step = tg.make_train_step(prior_cfg, den_cfg, tcfg, None, with_monitor=False)
    def lpdm_batches(name: str, seed: int):
        for b in feeds[name](seed):
            yield {k: b[k] for k in ("motion", "con", "emo", "sty")} | {
                "betas": betas_for_actor_ids(b["actor_id"])}

    step_ms = {name: [] for name in feeds}
    for rep, name in enumerate(("native", "window_cache", "window_cache", "native")):
        feed = prefetch_to_device(lpdm_batches(name, 3 + rep), 2, "cuda")
        step(state, next(feed), step_generator(0, rep, 0, "cuda"))  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(6):
            step(state, next(feed), step_generator(0, rep, 1 + i, "cuda"))
        torch.cuda.synchronize()
        step_ms[name].append((time.perf_counter() - t0) * 1e3 / 6)
        feed.close()
    ld.close()
    row = {"phase": "native_loader", "windows": NATIVE_WINDOWS, "batch": LPDM_BATCH,
           "abin_mb": abin.stat().st_size / 2**20, "cache_to_abin_s": abin_s,
           "windows_per_s": rates, "lpdm_unmonitored_step_ms": step_ms,
           "cli": phase_cli_native_loader(root / "cli")}
    emit(row)
    return row


def phase_cli_native_loader(root: Path) -> dict:
    """``--fn train_gesture`` with ``gesture.native_loader=true`` on the card
    at tiny widths (TINY_CFG, 2 takes x 4 windows, batch 4, the 3-step
    monitor every step): two epochs; a run of one epoch resumed to two logs
    the unbroken run's epoch 2 (rtol 1e-6); train.abin built beside the cache."""
    import numpy as np

    rng = np.random.default_rng(15)
    for actor_id, name in ((2, "scott"), (9, "miranda")):
        _write_take(root, actor_id, name, "0_9_9", 4, rng)
    log = OUT / "cli_native_loader.log"

    def cfg(work: str, epochs: int) -> str:
        c = dict(TINY_CFG, out_dir=str(root / work / "runs"),
                 gesture={**TINY_CFG["gesture"], "epochs": epochs, "batch_size": 4,
                          "model_save_freq": 1, "native_loader": True,
                          "vtex_displacement": False},
                 data={"data_root": str(root / "beat"), "mosh_root": str(root / "mosh"),
                       "cache_dir": str(root / "cache"), "stage1_dataset": str(root / "s1.npz"),
                       "smplx_model_dir": str(root / "nowhere")})
        (root / f"{work}.json").write_text(json.dumps(c))
        return str(root / f"{work}.json")

    def train(work: str, epochs: int, *extra) -> dict:
        _run_cli(["--fn", "train_gesture", "--cfg", cfg(work, epochs), *extra], log, root)
        run = sorted((root / work / "runs").iterdir())[-1]
        return {json.loads(x)["step"]: json.loads(x)
                for x in (run / "metrics.jsonl").read_text().splitlines()} | {"run": run}

    _run_cli(["--fn", "prepare_data", "--cfg", cfg("prep", 1)], log, root)
    _reset_counts()
    full = train("full", 2)
    k3_launches = _sampler_launches()
    part = train("part", 1)
    resumed = train("resumed", 2, "--set", f"resume={part['run'] / 'checkpoints'}")
    want, got = full.get(1, {}), resumed.get(1, {})
    keys = [k for k in want if k.startswith("train_")]
    check((root / "cache" / "train.abin").exists() and k3_launches == 4,
          f"native-loader CLI: train.abin missing or K3 launched {k3_launches} times (4)")
    check(0 not in resumed and keys and all(
        math.isfinite(want[k]) and abs(got[k] - want[k]) <= 1e-6 * abs(want[k]) for k in keys),
        f"native-loader run resumed at epoch 2 {got} differs from the unbroken run's {want}")
    return {"k3_launches": k3_launches, "epoch2": {k: want[k] for k in keys},
            "resumed_max_rel_diff": max(abs(got[k] - want[k]) / abs(want[k]) for k in keys)}


def run_eval() -> dict:
    """eval_gesture, train_embedder and the native loader, each in a
    temporary directory."""
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        rows["eval"] = phase_eval_gesture(Path(tmp) / "eval")
    rows["embedder"] = phase_train_embedder()
    with tempfile.TemporaryDirectory() as tmp:
        rows["native"] = phase_native_loader(Path(tmp))
    return rows


# the host-side tasks: bvh2smplx_ at BEAT's size, the render tasks, the
# render wiring of infer_gesture, blender_setup
BVH_TAKES = {"2_scott_0_9_9": 1800, "2_scott_0_10_10": 18000}  # 60 s and a 10 min conversation
BVH_AA_TOL = 1e-5  # converted poses, card against CPU, through their rotation matrices
RECORDING_STUB = """#!/bin/sh
echo "{name} $@" >> {log}
out=""
for a in "$@"; do case "$a" in *.mp4) out="$a";; esac; done
[ -n "$out" ] && : > "$out"
exit 0
"""


def _write_rig(path: Path, frames: int, seed: int, root: str = "pelvis", joints: int = 55):
    """A chain skeleton as an Auto-Rig-Pro export writes it (root position,
    ZYX rotation channels, frame time 0.033333) with random Euler angles, in
    the port's BVH writer."""
    import numpy as np

    from amuse_tpu_torch.data import bvh

    rng = np.random.default_rng(seed)
    rot = ["Zrotation", "Yrotation", "Xrotation"]
    js = [bvh.BvhJoint(root, -1, np.zeros(3), ["Xposition", "Yposition", "Zposition", *rot])]
    js += [bvh.BvhJoint(f"j{i}", i - 1, rng.normal(scale=10, size=3), list(rot))
           for i in range(1, joints)]
    js.append(bvh.BvhJoint(f"j{joints - 1}_end", joints - 1, np.array([0.0, 5.0, 0.0]), [],
                           is_end_site=True))
    data = rng.uniform(-180, 180, size=(frames, 6 + 3 * (joints - 1)))
    data[:, :3] = rng.normal(scale=50, size=(frames, 3))
    bvh.write_bvh(path, bvh.BvhData(js, data, 0.033333))


def _stubs(root: Path) -> tuple[Path, Path]:
    """Recording blender and ffmpeg stubs in ``root`` -> (bin dir, argv log)."""
    bindir, log = root / "stub_bin", root / "stub_calls.log"
    bindir.mkdir(parents=True, exist_ok=True)
    for name in ("blender", "ffmpeg"):
        (bindir / name).write_text(RECORDING_STUB.format(name=name, log=log))
        (bindir / name).chmod(0o755)
    return bindir, log


def _with_path(path: str, fn):
    """fn() with PATH set to ``path``, restored after."""
    saved = os.environ["PATH"]
    os.environ["PATH"] = path
    try:
        return fn()
    finally:
        os.environ["PATH"] = saved


def _bvh_split(root: Path) -> dict:
    """Per take: parse (host), Euler -> float64 matrices (host), matrix ->
    axis-angle on the card (CUDA events, the card-resident matrices) against
    the CPU (host clock), the whole conversion with its copies, and the npz
    write."""
    import torch

    from amuse_tpu_torch.core.rotations import matrix_to_axis_angle
    from amuse_tpu_torch.data import bvh

    rows = {}
    for stem in BVH_TAKES:
        t0 = time.perf_counter()
        parsed = bvh.parse_bvh(root / "beat" / "2" / f"{stem}.bvh")
        t1 = time.perf_counter()
        mats, _, _ = bvh.joint_matrices(parsed)
        t2 = time.perf_counter()
        m32 = torch.from_numpy(mats.astype("float32"))
        on_card = m32.cuda()
        card_ms = cuda_ms(lambda: matrix_to_axis_angle(on_card), iters=10, warmup=2)
        t3 = time.perf_counter()
        for _ in range(3):
            matrix_to_axis_angle(m32)
        cpu_ms = (time.perf_counter() - t3) / 3 * 1e3
        t4 = time.perf_counter()
        poses, trans, fps = bvh.retargeted_bvh_to_smplx(parsed, "cuda")
        t5 = time.perf_counter()
        bvh.write_smplx_take(root / "split" / f"{stem}.npz", poses, trans, fps, "scott")
        t6 = time.perf_counter()
        rows[stem] = {"frames": parsed.num_frames, "parse_s": t1 - t0, "euler_host_s": t2 - t1,
                      "axis_angle_card_ms": card_ms, "axis_angle_cpu_ms": cpu_ms,
                      "conversion_with_copies_s": t5 - t4, "write_s": t6 - t5}
    return rows


def phase_host_tasks(root: Path) -> dict:
    """bvh2smplx_ over a 60 s and a 10 min SMPL-X-rig take and a raw 75-joint
    BEAT skeleton, on the card and with --device cpu (the same counts, poses
    within BVH_AA_TOL, the rest equal); render_gt and render_baselines over
    the converted takes, their window npz trees card against CPU file by file;
    mux_audio and concat_grid on real ffmpeg where it is installed;
    blender_setup without Blender exits 1 naming it; infer_gesture at the
    flagship widths through the CLI with the render wiring (one render and one
    mux per window, 12 K1 and 1 K3 per wav_to_motion), against the same run
    without a blender on PATH."""
    import shutil

    import numpy as np
    import torch

    from amuse_tpu_torch.audio.wavio import save_wav
    from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
    from amuse_tpu_torch.ops import attention, denoiser_kernel

    t_start = time.perf_counter()
    (root / "beat" / "2").mkdir(parents=True)
    (root / "beat" / "9").mkdir(parents=True)
    for seed, (stem, frames) in enumerate(BVH_TAKES.items()):
        _write_rig(root / "beat" / "2" / f"{stem}.bvh", frames, seed)
    _write_rig(root / "beat" / "9" / "9_miranda_0_9_9.bvh", 120, 9, root="Hips", joints=75)
    rng = np.random.default_rng(3)
    save_wav(root / "beat" / "2" / "2_scott_0_9_9.wav",
             rng.normal(scale=0.05, size=60 * 16000).astype(np.float32))
    bvh_mb = sum(p.stat().st_size for p in (root / "beat").rglob("*.bvh")) / 1e6
    system_path = os.environ["PATH"]
    bindir, stub_log = _stubs(root)
    on_path = {b: shutil.which(b) is not None for b in ("blender", "ffmpeg")}
    stub_path = f"{bindir}{os.pathsep}{system_path}"  # the stubs shadow real binaries
    no_blender_path = os.pathsep.join(d for d in system_path.split(os.pathsep)
                                      if not (Path(d) / "blender").exists())

    # bvh2smplx_: the CLI on the card and on the CPU, then the split per take
    seconds, counts = {}, {}
    for device in ("cuda", "cpu"):
        cfg = {"data": {"data_root": str(root / "beat"), "mosh_root": str(root / f"mosh_{device}")},
               "out_dir": str(root / "runs" / device)}
        (root / f"{device}.json").write_text(json.dumps(cfg))
        log = OUT / f"cli_bvh2smplx_{device}.log"
        log.unlink(missing_ok=True)
        t0 = time.perf_counter()
        _with_path(no_blender_path, lambda: _run_cli(
            ["--fn", "bvh2smplx_", "--cfg", str(root / f"{device}.json"), "--device", device],
            log, root))
        seconds[device] = time.perf_counter() - t0
        m = re.search(r"converted (\d+), skipped (\d+)", log.read_text())
        counts[device] = (int(m.group(1)), int(m.group(2)))
        check("9_miranda_0_9_9.bvh: 75-joint BEAT skeleton; retarget needs Blender"
              in log.read_text(), "the raw BEAT skeleton was not skipped with its reason")
    check(counts["cuda"] == counts["cpu"] == (2, 1),
          f"bvh2smplx_ converted/skipped {counts}, expected (2, 1) on both")
    err = 0.0
    for stem, frames in BVH_TAKES.items():
        a, b = (np.load(root / f"mosh_{d}" / f"{stem}.npz") for d in ("cuda", "cpu"))
        for k in ("trans", "gender", "betas", "mocap_frame_rate"):
            check(np.array_equal(a[k], b[k]), f"bvh2smplx_ {stem}: {k} differs, card vs CPU")
        check(a["poses"].shape == (frames, 55, 3) and float(a["mocap_frame_rate"]) == 31.0,
              f"bvh2smplx_ {stem}: poses {a['poses'].shape}, fps {a['mocap_frame_rate']}")
        rot = [axis_angle_to_matrix(torch.from_numpy(d["poses"])) for d in (a, b)]
        err = max(err, max_err(*rot))
    check(err <= BVH_AA_TOL, f"bvh2smplx_ poses, card vs CPU: {err} > {BVH_AA_TOL}")
    split = _bvh_split(root)

    # render_gt and render_baselines over the converted takes, through the stubs
    method = root / "baselines" / "camn"
    method.mkdir(parents=True)
    d = np.load(root / "mosh_cuda" / "2_scott_0_9_9.npz")
    np.savez(method / "2_scott_0_9_9.npz", poses=d["poses"][::-1].reshape(-1, 165),
             trans=d["trans"])
    render_s, trees, stub_calls = {}, {}, {}
    for device in ("cuda", "cpu"):
        for task in ("render_gt", "render_baselines"):
            cfg = {"data": {"data_root": str(root / "beat"), "mosh_root": str(root / "mosh_cuda"),
                            "baselines_root": str(root / "baselines")},
                   "out_dir": str(root / task / device)}
            (root / f"{task}.json").write_text(json.dumps(cfg))
            stub_log.unlink(missing_ok=True)
            t0 = time.perf_counter()
            _with_path(stub_path, lambda: _run_cli(
                ["--fn", task, "--cfg", str(root / f"{task}.json"), "--device", device],
                OUT / f"cli_{task}.log", root))
            render_s[f"{task}_{device}"] = time.perf_counter() - t0
            (run,) = (root / task / device).iterdir()
            trees[task, device] = {str(p.relative_to(run)): p for p in sorted(run.rglob("*.npz"))}
            stub_calls[task, device] = stub_log.read_text().replace(str(run), "<run>")
    for task in ("render_gt", "render_baselines"):
        a, b = trees[task, "cuda"], trees[task, "cpu"]
        check(list(a) == list(b) and a, f"{task}: the card's npz tree differs from the CPU's")
        for rel in a:
            check(all(np.array_equal(x, y) for x, y in zip(*(
                [np.load(t[rel])[k] for k in ("poses", "trans", "betas", "mocap_frame_rate")]
                for t in (a, b)))), f"{task}: {rel} differs, card vs CPU")
        check(stub_calls[task, "cuda"] == stub_calls[task, "cpu"],
              f"{task}: the renders asked for differ, card vs CPU")
    gt_windows = sum(f // 300 for f in BVH_TAKES.values())
    check(len(trees["render_gt", "cuda"]) == gt_windows,
          f"render_gt wrote {len(trees['render_gt', 'cuda'])} windows, expected {gt_windows}")
    for stem in BVH_TAKES:  # render_gt of each take alone, for its time
        (root / "one" / stem).mkdir(parents=True)
        (root / "one" / stem / f"{stem}.npz").symlink_to(root / "mosh_cuda" / f"{stem}.npz")
        cfg = {"data": {"data_root": str(root / "beat"), "mosh_root": str(root / "one" / stem)},
               "out_dir": str(root / "one" / "runs" / stem)}
        (root / "one.json").write_text(json.dumps(cfg))
        t0 = time.perf_counter()
        _with_path(stub_path, lambda: _run_cli(["--fn", "render_gt", "--cfg", str(root / "one.json")],
                                               OUT / "cli_render_gt.log", root))
        render_s[f"render_gt_{stem}"] = time.perf_counter() - t0

    # ffmpeg for real on lavfi clips, where it is installed
    ffmpeg = {"on_path": on_path["ffmpeg"]}
    if on_path["ffmpeg"]:
        ffmpeg.update(_real_ffmpeg(root / "ffmpeg"))

    # blender_setup with no Blender on PATH: its specified result is exit 1
    log = OUT / "cli_blender_setup.log"
    try:
        _with_path(no_blender_path, lambda: _run_cli(
            ["--fn", "blender_setup", "--cfg", str(root / "cuda.json")], log, root))
        code = 0
    except SystemExit as e:
        code = e.code
    check(code == 1 and "blender executable 'blender' not found on PATH" in log.read_text(),
          f"blender_setup without Blender exited {code}, not 1 with Blender named missing")

    # infer_gesture at the flagship widths with the render wiring, against no blender
    (root / "wavs").mkdir()
    save_wav(root / "wavs" / "2_scott_0_9_9.wav",
             rng.normal(scale=0.05, size=320000).astype(np.float32))
    infer, launches = {}, {}
    for mode, path in (("render_wiring", stub_path), ("no_blender", no_blender_path),
                       ("render_wiring_2", stub_path)):
        (root / "infer.json").write_text(json.dumps({"out_dir": str(root / "infer" / mode)}))
        stub_log.unlink(missing_ok=True)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _with_path(path, lambda: _run_cli(
            ["--fn", "infer_gesture", "--cfg", str(root / "infer.json"),
             "--wav-dir", str(root / "wavs")], OUT / "cli_infer_render.log", root))
        torch.cuda.synchronize()
        infer[mode] = time.perf_counter() - t0
        launches[mode] = {"attention_fwd": attention.mha.launches,
                          "ddim_sampler": denoiser_kernel.ddim_sample_fused.launches}
        calls = stub_log.read_text().splitlines() if stub_log.exists() else []
        renders = [c for c in calls if c.startswith("blender")]
        muxes = [c for c in calls if c.startswith("ffmpeg")]
        want = (2, 2) if path == stub_path else (0, 0)
        check((len(renders), len(muxes)) == want,
              f"infer_gesture ({mode}): {len(renders)} renders, {len(muxes)} muxes, want {want}")
        check(launches[mode] == {"attention_fwd": 12, "ddim_sampler": 1},
              f"infer_gesture ({mode}) launched {launches[mode]}, expected 12 K1 and 1 K3")
        if renders:
            check("-ss 10.0 -t 10.0" in muxes[1], "the second window's audio is not at 10 s")
    check(os.environ["PATH"] == system_path, "PATH was not restored")
    row = {"phase": "host_tasks", "bvh_mb": bvh_mb,
           "bvh2smplx": {"cli_s": seconds, "counts": counts, "max_abs_err": err,
                         "tolerance": BVH_AA_TOL, "per_take": split},
           "render_s": render_s, "render_gt_windows": gt_windows,
           "blender": "stub", "blender_on_path": on_path["blender"], "ffmpeg": ffmpeg,
           "blender_setup_exit": code, "infer_gesture_cli_s": infer,
           "launches_per_infer_cli": launches["render_wiring"],
           "seconds": time.perf_counter() - t_start}
    emit(row)
    return row


def _real_ffmpeg(root: Path) -> dict:
    """mux_audio and concat_grid on real ffmpeg over 2 s lavfi test clips:
    the mux is cut to its 1 s audio slice, the 2-column grid is twice as wide."""
    from amuse_tpu_torch.viz.export import concat_grid, mux_audio

    root.mkdir()

    def ff(*args):
        r = subprocess.run(["ffmpeg", "-y", "-v", "error", *args], capture_output=True, text=True,
                           timeout=120)
        check(r.returncode == 0, f"ffmpeg {args}: {r.stderr[-500:]}")

    def probe(p: Path) -> tuple:
        r = subprocess.run(["ffmpeg", "-i", str(p)], capture_output=True, text=True, timeout=60)
        dur = re.search(r"Duration: (\d+):(\d+):([\d.]+)", r.stderr)
        size = re.search(r"Video: .*?(\d{2,5})x(\d{2,5})", r.stderr)
        return (int(dur[1]) * 3600 + int(dur[2]) * 60 + float(dur[3]),
                (int(size[1]), int(size[2])), p.stat().st_size)

    for name in ("a", "b"):
        ff("-f", "lavfi", "-i", "testsrc=duration=2:size=128x96:rate=30", "-c:v", "mpeg4",
           str(root / f"{name}.mp4"))
    ff("-f", "lavfi", "-i", "sine=frequency=440:duration=3", str(root / "a.wav"))
    t0 = time.perf_counter()
    check(mux_audio(root / "a.mp4", root / "a.wav", root / "muxed.mp4", offset=0.5, duration=1.0),
          "mux_audio failed on real ffmpeg")
    t1 = time.perf_counter()
    check(concat_grid([root / "a.mp4", root / "b.mp4"], root / "grid.mp4", cols=2),
          "concat_grid failed on real ffmpeg")
    t2 = time.perf_counter()
    muxed, grid = probe(root / "muxed.mp4"), probe(root / "grid.mp4")
    check(abs(muxed[0] - 1.0) < 0.2 and muxed[1] == (128, 96) and muxed[2] > 0,
          f"muxed clip: duration, size, bytes {muxed}")
    check(abs(grid[0] - 2.0) < 0.2 and grid[1] == (256, 96) and grid[2] > 0,
          f"grid: duration, size, bytes {grid}")
    return {"mux_s": t1 - t0, "grid_s": t2 - t1, "muxed": muxed, "grid": grid}


def run_host_tasks() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return phase_host_tasks(Path(tmp))


# the legacy zoo and MFCC + DTW (ROADMAP item 17): plain PyTorch, cuDNN and
# cuBLAS; no kernel of the port lies on this path
LEGACY_TOL = 1e-5  # float32 forwards and BatchNorm statistics, card against CPU,
#                    of the CPU's largest magnitude (or 1)
LEGACY_PARAM_TOL = 1e-6  # parameters after three raw train steps (lr 1e-4)
# the key projections' biases: zero gradient in exact arithmetic, so Adam
# moves them by +-lr per step on the sign of each device's rounding noise
LEGACY_KEY_BIAS_TOL = 3 * 2 * 1e-4
# MFCC coefficients of 100-500, cuFFT against pocketfft (reading on an H100: 4.6e-5)
LEGACY_MFCC_TOL = 2e-4
# accumulated DTW costs, of the largest (reading on an H100: 8.2e-8; the
# pairwise distances come from a matmul over MFCC norms of ~1e5)
LEGACY_DTW_RTOL = 1e-6
LEGACY_BATCH = 32  # configs/train_gesture.json:6, the reference's diffusion batch
SMALL_RAW = {"nfeats": 12, "latent_dim": 16, "ff_size": 32, "num_layers": 2, "num_heads": 2,
             "cond_dim": 8, "window": 6, "dropout": 0.0}


def _seeded(module, seed: int):
    """Every parameter from a seeded CPU normal (std 0.2; norm scales around
    1), so zero-initialised maps (Faceformer's output) are non-zero; eval mode."""
    import torch

    from amuse_tpu_torch.models.legacy_family import BatchNorm

    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in module.modules()
             if isinstance(m, (torch.nn.LayerNorm, BatchNorm))}
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g) + (1.0 if id(p) in norms else 0.0))
    return module.eval()


def _flat(out) -> list:
    """A forward's tensors in a fixed order (dicts by key, tuples in order)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _zoo(small: bool) -> dict:
    """tag -> (module on the CPU with seeded weights, inputs on the CPU, call).

    Small widths for the card-against-CPU check; else each member at its
    default widths, batch LEGACY_BATCH, 300 frames, the text encoder at
    GPT-2 small's widths over 64 tokens with left padding."""
    import torch

    from amuse_tpu_torch.models import actor, audio_legacy, legacy_family as lf, raw_diffusion

    g = torch.Generator().manual_seed(7)
    b, t = (4, 6) if small else (LEGACY_BATCH, 300)

    def x(*shape):
        return torch.randn(shape, generator=g)

    def ids(high, *shape):
        return torch.randint(0, high, shape, generator=g)

    raw_cfg = (raw_diffusion.RawDenoiserConfig(**SMALL_RAW) if small
               else raw_diffusion.RawDenoiserConfig())
    audio_cfg = (audio_legacy.LegacyAudioConfig(channels=4, latent_dim=8) if small
                 else audio_legacy.LegacyAudioConfig())
    camn_cfg = (lf.CaMNConfig(nfeats=6, latent_dim=8, fusion_dim=8, num_layers=2, audio_dim=4,
                              text_dim=3) if small else lf.CaMNConfig())
    face_kw = (dict(n_face_feats=5, audio_dim=3, latent_dim=8, num_heads=2, ff_size=16,
                    num_layers=2) if small else {})
    actor_cfg = (actor.ActorConfig(njoints=2, nfeats=3, num_frames=t, latent_dim=8, ff_size=16,
                                   num_layers=2, num_heads=2, dropout=0.0) if small
                 else actor.ActorConfig(dropout=0.0))
    gpt2 = None if small else lf.GPT2Config()
    n_tok = 7 if small else 64
    mask = torch.ones((b, n_tok), dtype=torch.long)
    for i in range(b):  # left padding: position ids -1 on the padded tokens
        mask[i, : int(torch.randint(0, n_tok // 2, (1,), generator=g))] = 0
    face_t = 30 if small else t
    camn_args = (x(b, t, camn_cfg.nfeats), x(b, t, camn_cfg.audio_dim), ids(8, b, t),
                 ids(30, b, t))
    if small:
        camn_args += (x(b, t, 3),)
    zoo = {
        "diffusion": (raw_diffusion.RawPoseDenoiser(raw_cfg),
                      (x(b, raw_cfg.window, raw_cfg.nfeats), ids(1000, b), x(b, raw_cfg.cond_dim),
                       x(b, raw_cfg.cond_dim)), None),
        "wav_mfcc": (audio_legacy.AutoEncoder3x(audio_cfg),
                     (x(b, audio_cfg.in_frames, audio_cfg.in_coeffs),), None),
        "camn_lstm": (lf.CaMNPoseGenerator(camn_cfg), camn_args, None),
        "faceformer": (lf.FaceformerDecoder(**face_kw),
                       (x(b, face_t, face_kw.get("n_face_feats", 100)),
                        x(b, face_t, face_kw.get("audio_dim", 256)), ids(30, b), ids(8, b)), None),
        "txt_gpt2": (lf.TextEncoder(8 if small else 256, gpt2_config=gpt2),
                     (ids(50257, b, n_tok), mask), None),
        "discriminator": (lf.ConvDiscriminator(3, (4, 6)) if small else lf.ConvDiscriminator(),
                          (x(b, 7 if small else t, 3 if small else 168),), None),
        "actor_ae": (actor.ActorAE(actor_cfg),
                     (x(b, t, actor_cfg.input_feats), ids(actor_cfg.num_classes, b)),
                     lambda m, a: (lambda out: (out, m.decode(out["z"], t)))(m(*a))),
    }
    if small:  # the discriminator at an even length too
        zoo["discriminator_even"] = (lf.ConvDiscriminator(3, (4, 6)), (x(b, 8, 3),), None)
    return {k: (_seeded(m, i), a, c) for i, (k, (m, a, c)) in enumerate(zoo.items())}


def _run_member(module, args, call):
    import torch

    with torch.no_grad():
        return _flat(call(module, args) if call else module(*args))


def _legacy_small_vs_cpu(smi: str) -> dict:
    """Each zoo member's forward at small widths on the card against the
    CPU, the CaMN generator's BatchNorm in train mode, three raw train steps
    with injected draws, both samplers at T = 50 with injected noise."""
    import copy

    import torch

    from amuse_tpu_torch.diffusion import gaussian as G
    from amuse_tpu_torch.models.raw_diffusion import RawDenoiserConfig
    from amuse_tpu_torch.train import raw_diffusion as tr

    def rel(a, b):
        return max_err(a.cpu(), b) / max(1.0, b.abs().max().item())

    errs, zoo = {}, _zoo(small=True)
    for tag, (module, args, call) in zoo.items():
        want = _run_member(module, args, call)
        got = _run_member(copy.deepcopy(module).cuda(), [a.cuda() for a in args], call)
        errs[tag] = max(rel(a, b) for a, b in zip(got, want))
    camn, camn_args, _ = zoo["camn_lstm"]
    card = copy.deepcopy(camn).cuda().train()
    with torch.no_grad():
        got, want = card(*[a.cuda() for a in camn_args]), camn.train()(*camn_args)
    errs["camn_lstm_train"] = max(
        [rel(got, want)] + [rel(a.running_var, b.running_var)
                            for a, b in zip(card.emo_addon.bns, camn.emo_addon.bns)]
        + [rel(a.running_mean, b.running_mean)
           for a, b in zip(card.emo_addon.bns, camn.emo_addon.bns)])

    # three raw train steps, the draws made once on the CPU
    cfg_m = RawDenoiserConfig(**SMALL_RAW)
    cfg = tr.RawTrainConfig(num_timesteps=50)
    states = {d: tr.init_state(0, cfg_m, cfg, d) for d in ("cpu", "cuda")}
    step, sample_fn = tr.make_train_step(cfg_m, cfg)
    g = torch.Generator().manual_seed(3)
    batch = {"motion": 0.3 * torch.randn((8, 6, 12), generator=g),
             "con": torch.randn((8, 8), generator=g), "emo": torch.randn((8, 8), generator=g)}
    loss_err = 0.0
    for i in range(3):
        draw = tr.RawStepDraw(torch.randint(0, 50, (8,), generator=g),
                              torch.randn((8, 6, 12), generator=g))
        logs = {d: step(s, {k: v.to(d) for k, v in batch.items()}, None,
                        tr.RawStepDraw(*(v.to(d) for v in draw)))
                for d, s in states.items()}
        loss_err = max(loss_err, abs(logs["cuda"]["loss"].item() / logs["cpu"]["loss"].item() - 1))
    cpu_p = dict(states["cpu"].model.named_parameters())
    param_err = key_bias_err = 0.0
    d = cfg_m.latent_dim
    for name, p in states["cuda"].model.named_parameters():
        a, b = p.detach().cpu(), cpu_p[name].detach()
        if name.endswith("in_proj_bias"):
            key_bias_err = max(key_bias_err, max_err(a[d:2 * d], b[d:2 * d]))
            a, b = torch.cat([a[:d], a[2 * d:]]), torch.cat([b[:d], b[2 * d:]])
        param_err = max(param_err, max_err(a, b))
    ss = [states[k].sampler_state for k in ("cuda", "cpu")]
    sampler_state_err = rel(ss[0].loss_sq_history, ss[1].loss_sq_history)
    check(torch.equal(ss[0].counts.cpu(), ss[1].counts), "loss-aware counts differ")
    # both samplers at T = 50 from one injected draw
    noise = torch.randn((51, 2, 6, 12), generator=g)
    cond = {"con": batch["con"][:2], "emo": batch["emo"][:2]}
    anc = {dev: sample_fn(states[dev].model, {k: v.to(dev) for k, v in cond.items()},
                          noise=noise.to(dev)) for dev in ("cpu", "cuda")}
    ddim = {}
    for dev in ("cpu", "cuda"):
        model, c = states[dev].model, {k: v.to(dev) for k, v in cond.items()}
        gd = tr.make_diffusion(cfg, dev)
        with torch.no_grad():
            ddim[dev] = G.ddim_sample_loop(gd, lambda xt, tt: model(xt, tt, c["con"], c["emo"]),
                                           (2, 6, 12), 10, noise=noise[0].to(dev))
    row = {"phase": "legacy_small_vs_cpu", "nvidia_smi": smi, "forward_rel_err": errs,
           "forward_tolerance": LEGACY_TOL, "train_loss_rel_err": loss_err,
           "train_param_err": param_err, "train_param_tolerance": LEGACY_PARAM_TOL,
           "train_key_bias_err": key_bias_err, "train_key_bias_tolerance": LEGACY_KEY_BIAS_TOL,
           "sampler_state_rel_err": sampler_state_err,
           "p_sample_rel_err": rel(anc["cuda"], anc["cpu"]),
           "ddim_rel_err": rel(ddim["cuda"], ddim["cpu"])}
    emit(row)
    check(all(v <= LEGACY_TOL for v in errs.values()), f"zoo forwards, card vs CPU: {errs}")
    check(loss_err <= LEGACY_TOL and sampler_state_err <= LEGACY_TOL,
          f"raw train steps, card vs CPU: loss {loss_err}, sampler state {sampler_state_err}")
    check(param_err <= LEGACY_PARAM_TOL and key_bias_err <= LEGACY_KEY_BIAS_TOL,
          f"raw train step parameters, card vs CPU: {param_err}, key biases {key_bias_err}")
    check(row["p_sample_rel_err"] <= LEGACY_TOL and row["ddim_rel_err"] <= LEGACY_TOL,
          f"samplers, card vs CPU: {row['p_sample_rel_err']}, {row['ddim_rel_err']}")
    return row


def _legacy_train_and_samplers(smi: str, steps: int = 10) -> dict:
    """The raw-diffusion train step at the RawDenoiserConfig defaults (168
    features, 256 wide, ff 1024, 8 layers, 4 heads, 300 frames, cond 256),
    batch 32, T = 1000 cosine, loss-aware timesteps: ``steps`` timed steps
    (CUDA events, host enqueue), peak memory, one step traced for its
    launches; then ``sample_fn``'s 1,000-step ancestral loop at N = 4 and
    the 50-step DDIM loop at N = 4 and 32."""
    import torch

    from amuse_tpu_torch.diffusion import gaussian as G
    from amuse_tpu_torch.models.raw_diffusion import RawDenoiserConfig
    from amuse_tpu_torch.train import raw_diffusion as tr

    cfg_m, cfg = RawDenoiserConfig(), tr.RawTrainConfig()
    state = tr.init_state(0, cfg_m, cfg, "cuda")
    step, sample_fn = tr.make_train_step(cfg_m, cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    b = LEGACY_BATCH
    batch = {"motion": 0.3 * torch.randn((b, cfg_m.window, cfg_m.nfeats), generator=g,
                                         device="cuda"),
             "con": torch.randn((b, cfg_m.cond_dim), generator=g, device="cuda"),
             "emo": torch.randn((b, cfg_m.cond_dim), generator=g, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, batch, g)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    host_ms = []
    events[0].record()
    for i in range(steps):
        t0 = time.perf_counter()
        logs = step(state, batch, g)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(c) for a, c in zip(events, events[1:])]
    loss = logs["loss"].item()
    check(math.isfinite(loss), f"raw train step loss not finite: {loss}")
    counts = int(state.sampler_state.counts.sum())
    check(counts == (steps + 2) * b, f"the sampler state holds {counts} losses")
    peak = torch.cuda.max_memory_allocated() / 2**30
    traced = trace_call(lambda: step(state, batch, g), "raw_diffusion_step")
    n_params = sum(p.numel() for p in state.model.parameters())
    emit({"phase": "legacy_raw_train_step", "nvidia_smi": smi, "batch": b, "params": n_params,
          "steps": steps, "ms_per_step": sum(step_ms) / steps, "device_ms_each": step_ms,
          "host_enqueue_ms_each": host_ms, "peak_gib": peak, "loss": loss,
          "launches_per_step": traced["device_launches"],
          "traced_wall_ms": traced["wall_ms"], "traced_device_busy_ms": traced["device_busy_ms"],
          "top": traced["top"][:6]})

    cond4 = {k: v[:4] for k, v in batch.items() if k != "motion"}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    x = sample_fn(state.model, cond4, g)
    end.record()
    torch.cuda.synchronize()
    anc_wall = (time.perf_counter() - t0) * 1e3
    check(x.shape == (4, cfg_m.window, cfg_m.nfeats) and bool(torch.isfinite(x).all()),
          "ancestral samples")
    gd = tr.make_diffusion(cfg, "cuda")
    ddim = {}
    for n in (4, 32):
        con, emo = batch["con"][:n], batch["emo"][:n]

        def run():
            with torch.no_grad():
                return G.ddim_sample_loop(gd, lambda xt, tt: state.model(xt, tt, con, emo),
                                          (n, cfg_m.window, cfg_m.nfeats), 50, g)

        check(bool(torch.isfinite(run()).all()), f"DDIM samples at N = {n}")
        ms = cuda_ms(run, iters=3, warmup=1)
        ddim[n] = {"ms": ms, "ms_per_window": ms / n}
    row = {"phase": "legacy_samplers", "nvidia_smi": smi,
           "ancestral_n4": {"steps": cfg.num_timesteps, "ms": start.elapsed_time(end),
                            "wall_ms": anc_wall, "ms_per_window": start.elapsed_time(end) / 4,
                            "ms_per_step": start.elapsed_time(end) / cfg.num_timesteps},
           "ddim_50_steps": ddim}
    emit(row)
    return row


def _legacy_mfcc_dtw(smi: str) -> dict:
    """``mfcc`` over 32 clips of 10 s on the card (and 4 of them against the
    CPU), ``dtw_cost`` for one 10 s pair on the card and on the CPU."""
    import torch

    from amuse_tpu_torch.audio import mfcc as M

    g = torch.Generator().manual_seed(11)
    n = 160_000
    s = torch.arange(n) / 16_000.0
    f0 = 100.0 + 300.0 * torch.rand((LEGACY_BATCH, 1), generator=g)
    waves = (0.3 * torch.sin(2 * math.pi * f0 * s * (1 + 0.1 * torch.sin(2 * math.pi * 0.5 * s)))
             + 0.02 * torch.randn((LEGACY_BATCH, n), generator=g))
    waves[::4, n // 2:] = 0.0  # silent tails
    card = waves.cuda()
    out = M.mfcc(card)
    check(out.shape == (LEGACY_BATCH, n // 128 + 1, 13) and bool(torch.isfinite(out).all()),
          f"mfcc shape {tuple(out.shape)}")
    mfcc_ms = cuda_ms(lambda: M.mfcc(card), iters=5, warmup=1)
    mfcc_err = max_err(out[:4].cpu(), M.mfcc(waves[:4]))
    a, b = out[0], out[1]
    acc = M.dtw_cost(a, b)
    dtw_ms = cuda_ms(lambda: M.dtw_cost(a, b), iters=3, warmup=1)
    t0 = time.perf_counter()
    ref = M.dtw_cost(a.cpu(), b.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    dtw_err = max_err(acc.cpu(), ref) / ref.abs().max().item()
    row = {"phase": "legacy_mfcc_dtw", "nvidia_smi": smi, "clips": LEGACY_BATCH, "seconds": 10,
           "mfcc_ms": mfcc_ms, "mfcc_ms_per_clip": mfcc_ms / LEGACY_BATCH,
           "mfcc_max_abs_err_vs_cpu": mfcc_err, "mfcc_tolerance": LEGACY_MFCC_TOL,
           "dtw_frames": [a.shape[0], b.shape[0]], "dtw_ms": dtw_ms, "dtw_cpu_ms": cpu_ms,
           "dtw_rel_err_vs_cpu": dtw_err, "dtw_tolerance": LEGACY_DTW_RTOL}
    emit(row)
    check(mfcc_err <= LEGACY_MFCC_TOL, f"mfcc, card vs CPU: {mfcc_err}")
    check(dtw_err <= LEGACY_DTW_RTOL, f"dtw_cost, card vs CPU: {dtw_err}")
    return row


def _legacy_forwards(smi: str) -> dict:
    """One forward of each zoo member at its default widths (CUDA events)."""
    import torch

    rows = {}
    for tag, (module, args, call) in _zoo(small=False).items():
        module = module.cuda()
        args = [a.cuda() for a in args]
        out = _run_member(module, args, call)
        check(all(bool(torch.isfinite(o).all()) for o in out), f"{tag}: non-finite output")
        rows[tag] = {"ms": cuda_ms(lambda: _run_member(module, args, call), iters=5, warmup=1),
                     "params": sum(p.numel() for p in module.parameters()),
                     "out_shapes": [list(o.shape) for o in out]}
        module.cpu()
    emit({"phase": "legacy_zoo_forwards", "nvidia_smi": smi, "batch": LEGACY_BATCH,
          "members": rows})
    return rows


def phase_legacy(smi: str) -> dict:
    """The legacy zoo and MFCC + DTW, with the K1, K2 and K3 counters held at 0."""
    from amuse_tpu_torch.ops import denoiser_kernel

    _reset_counts()
    t0 = time.perf_counter()
    rows = {"small": _legacy_small_vs_cpu(smi), "train": _legacy_train_and_samplers(smi),
            "mfcc_dtw": _legacy_mfcc_dtw(smi), "forwards": _legacy_forwards(smi)}
    counts = {**_launch_counts(), "ddim_sampler": denoiser_kernel.ddim_sample_fused.launches}
    emit({"phase": "legacy_kernel_launches", "nvidia_smi": smi, "launches": counts,
          "seconds": time.perf_counter() - t0})
    check(not any(counts.values()), f"the legacy path launched the port's kernels: {counts}")
    return rows


# data parallelism (parallel/mesh.py): one card, so the NCCL path at world
# size 1 in this process, two gloo ranks sharing the card, and the
# train_gesture CLI launched through cluster/jobs.py at world size 1
# two ranks against one process (tests/torch_port_dist.py's bounds): every
# logged term of both steps; the first step's gradients, per parameter, of its
# largest entry; the parameters after the first step where its gradient
# exceeds DP_GRAD_FLOOR (Adam moves the others by a sign-like ~lr, and the
# second step inherits that: its losses hold it), at least DP_COVERED of them
# (an H100 held 46% of the stage-1 parameters over 1024x128 fbanks, where the
# gradients are smaller than at the CPU tests' 64x32 and 59-84% are held)
DP_LOSS_RTOL, DP_GRAD_REL = 1e-5, 1e-4
DP_PARAM_ATOL, DP_GRAD_FLOOR, DP_COVERED = TRAIN_LR / 10, 1e-6, 0.25
DP_FBANK_TOL = 1e-5  # sharded fbank / encode_audio against one call on the card
DP_CLI_RTOL = 1e-6  # the world-1 CLI's logged losses against a plain run's
DP_SMALL_B = 8  # the small LPDM step's global batch
DP_CHUNKS = 6  # the sharded fbank's and encode's chunks


def _dp_errors(got: dict, want: dict) -> dict:
    """A rank's two steps against one process's: as tests/torch_port_dist.errors."""
    import torch

    loss = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-7) for k in w)
            for g, w in zip(got["logs"], want["logs"])]
    g0, w0 = got["grads"][0], want["grads"][0]
    check(g0.keys() == w0.keys(), "the ranks' gradients cover other parameters")
    grad = max(((g0[n] - w0[n]).abs().max() / w0[n].abs().max().clamp_min(1e-30)).item()
               for n in w0)
    param, covered = 0.0, 0
    for n, p in want["params_1"].items():
        if n not in w0:
            continue
        keep = w0[n].abs() > DP_GRAD_FLOOR
        if keep.any():
            param = max(param, (got["params_1"][n] - p).abs()[keep].max().item())
        covered += int(keep.sum())
    return {"loss_rel_err": loss, "grad_rel_err": grad, "param_1_max_abs_err": param,
            "param_share_held": covered / sum(p.numel() for p in want["params_1"].values())}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _timed_ms(fn) -> float:
    """Host ms of fn() to a synchronise."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _world1_case(name: str, state_s, state_u, params_of, make_step, batch, gen,
                 want_counts: dict, steps: int = 2, timed: int = 3, fill=None) -> dict:
    """One flagship train step at world size 1 over NCCL. ``state_s`` steps
    with the gradient sync (recorded: the gradients before and after it);
    ``state_u``, a copy, takes the plain optimizer step on the same
    gradients (after ``fill(state_u)``, the step's own zero fill of the
    gradients the loss did not reach, where given), so the check does not
    rest on the step's own determinism.
    Then ms per step without and with the sync in turns (host clock to a
    synchronise), launches counted, and the all-reduce alone on CUDA events."""
    import torch

    from amuse_tpu_torch.parallel import mesh as M

    mesh = M.current_mesh()

    class Recorded(M.GradSync):
        def all_reduce(self, params):
            params = list(params)
            self.before = [None if p.grad is None else p.grad.detach().clone() for p in params]
            super().all_reduce(params)
            self.identity = all((b is None) == (p.grad is None)
                                and (b is None or torch.equal(b, p.grad))
                                for b, p in zip(self.before, params))

    rec = Recorded(mesh)
    step_rec = make_step(rec)
    identity = []
    for i in range(steps):
        step_rec(state_s, batch, gen(i))
        identity.append(rec.identity)
        for p, g in zip(params_of(state_u), rec.before):
            p.grad = g
        if fill is not None:
            fill(state_u)
        state_u.optimizer.step()
        state_u.step += 1
        rec.before = None
    equal = all(torch.equal(a, b) for a, b in zip(params_of(state_s), params_of(state_u)))
    n_grads = sum(p.grad is not None for p in params_of(state_s))
    grad_bytes = sum(p.grad.numel() * p.grad.element_size()
                     for p in params_of(state_s) if p.grad is not None)
    check(all(identity) and equal, f"{name}: the world-1 sync changed the gradients "
          f"({identity}) or the parameters after {steps} steps (equal: {equal})")
    plain, synced = make_step(None), make_step(M.GradSync(mesh))
    ms = {"plain": [], "synced": []}
    _reset_counts()
    for kind in ("plain", "synced", "synced", "plain"):
        fn, state = (plain, state_u) if kind == "plain" else (synced, state_s)
        for i in range(timed):
            ms[kind].append(_timed_ms(lambda: fn(state, batch, gen(100 + i))))
    counts = {**_launch_counts(), "ddim_sampler": _sampler_launches()}
    per_step = {k: v / (4 * timed) for k, v in counts.items()}
    check(per_step == want_counts, f"{name}: launches per step {per_step}, expected {want_counts}")
    grads = [p for p in params_of(state_s) if p.grad is not None]
    ar_ms = cuda_ms(lambda: M.all_reduce_grads(grads, mesh), iters=5, warmup=1)
    return {"params": sum(p.numel() for p in params_of(state_s)), "grads": n_grads,
            "grad_gb": grad_bytes / 1e9, "buckets": len(M._buckets(grads, M.BUCKET_BYTES)),
            "identity_each_step": identity, "params_bit_equal_after": steps,
            "ms_per_step": {k: sum(v) / len(v) for k, v in ms.items()}, "ms_each": ms,
            "all_reduce_ms": ar_ms, "all_reduce_gb_per_s": grad_bytes / 1e9 / (ar_ms / 1e3),
            "launches_per_step": per_step}


def phase_distributed_world1() -> dict:
    """(a) NCCL at world size 1: the launcher's environment set in this
    process, ``initialize_distributed`` (env://), the flagship stage-1 step
    (bf16, 1 quad, dropout and augmentation on) and the flagship LPDM step
    (batch 32, the DDIM monitor every step) with and without the sync."""
    import copy

    import torch

    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.parallel import mesh as M
    from amuse_tpu_torch.train import audio as ta
    from amuse_tpu_torch.train import gesture as tg

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        dev = M.initialize_distributed("cuda")
        check(torch.distributed.get_backend() == "nccl" and dev == torch.device("cuda", 0),
              f"world-1 bring-up: {torch.distributed.get_backend()} on {dev}")
        init_s = time.perf_counter() - t0
        cfg, ast_cfg = ta.AudioTrainConfig(), ASTConfig()
        s = ta.init_state(0, cfg, torch.bfloat16, ast_cfg, "cuda")
        model_u = copy.deepcopy(s.model)
        u = ta.AudioTrainState(model_u, ta.make_optimizer(model_u, cfg))
        stage1 = _world1_case(
            "stage-1", s, u, lambda st: list(st.model.parameters()),
            lambda sync: ta.make_train_step(cfg, sync)[0],
            _train_batch(1, ast_cfg.input_tdim, ast_cfg.input_fdim, 1, torch.device("cuda")),
            lambda i: ta.step_generator(0, 0, i, "cuda"),
            {"attention_fwd": ast_cfg.depth, "attention_bwd": ast_cfg.depth, "ddim_sampler": 0},
            fill=lambda st: ta.fill_missing_grads(st.model, cfg.frame_based_feats))
        del s, u, model_u
        torch.cuda.empty_cache()
        tcfg, prior_cfg, den_cfg = tg.GestureTrainConfig(), PriorConfig(), DenoiserConfig()
        s = tg.init_state(0, prior_cfg, den_cfg, tcfg, "cuda")
        prior_u, den_u = copy.deepcopy(s.prior), copy.deepcopy(s.denoiser)
        u = tg.GestureTrainState(prior_u, den_u, tg.make_optimizer(prior_u, den_u, tcfg))
        lpdm = _world1_case(
            "LPDM", s, u, lambda st: [*st.prior.parameters(), *st.denoiser.parameters()],
            lambda sync: tg.make_train_step(prior_cfg, den_cfg, tcfg, None, True, grad_sync=sync),
            _lpdm_batch(LPDM_BATCH, prior_cfg.window, den_cfg.cond_dim, 1, torch.device("cuda")),
            lambda i: ta.step_generator(0, 0, i, "cuda"),
            {"attention_fwd": 0, "attention_bwd": 0, "ddim_sampler": 1})
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    row = {"phase": "distributed_world1_nccl", "init_s": init_s, "stage1": stage1, "lpdm": lpdm,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def _dp_lpdm(mesh, device, steps: int = 2, dropout: float = 0.0) -> dict:
    """Two small LPDM steps (SMALL_PRIOR/SMALL_DENOISER at ``dropout``, the
    50-step monitor, no vertex monitors) over the global batch of DP_SMALL_B
    windows, this rank's rows, the draws (and the dropout masks, drawn for the
    global batch) from the step's generator."""
    import torch

    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.parallel import mesh as M
    from amuse_tpu_torch.train import gesture as tg
    from amuse_tpu_torch.train.audio import step_generator

    prior_cfg = PriorConfig(**SMALL_PRIOR, dropout=dropout)
    den_cfg = DenoiserConfig(**SMALL_DENOISER, dropout=dropout)
    tcfg = tg.GestureTrainConfig(learning_rate=TRAIN_LR)
    state = tg.init_state(21, prior_cfg, den_cfg, tcfg, device)
    M.replicate([state.prior, state.denoiser], mesh)
    step = tg.make_train_step(prior_cfg, den_cfg, tcfg, None, True,
                              grad_sync=None if mesh is None else M.GradSync(mesh))
    batch = M.shard_rows(_lpdm_batch(DP_SMALL_B, prior_cfg.window, den_cfg.cond_dim, 3,
                                     torch.device(device)), mesh)
    _reset_counts()
    t0, logs, grads = time.perf_counter(), [], []
    for i in range(steps):
        logs.append({k: v.item() for k, v in step(state, batch,
                                                   step_generator(7, 0, i, device)).items()})
        grads.append({f"{m}.{n}": p.grad.detach().cpu()
                      for m, mod in (("prior", state.prior), ("denoiser", state.denoiser))
                      for n, p in mod.named_parameters() if p.grad is not None})
        if i == 0:
            params_1 = {f"{m}.{n}": p.detach().cpu().clone()
                        for m, mod in (("prior", state.prior), ("denoiser", state.denoiser))
                        for n, p in mod.named_parameters()}
    torch.cuda.synchronize()
    return {"logs": logs, "grads": grads, "params_1": params_1, "s": time.perf_counter() - t0,
            "rows": batch["motion"].shape[0],
            "launches": {**_launch_counts(), "ddim_sampler": _sampler_launches()},
            "params": {f"{m}.{n}": p.detach().cpu() for m, mod in (("prior", state.prior),
                                                                   ("denoiser", state.denoiser))
                       for n, p in mod.named_parameters()}}


def _dp_stage1(mesh, device, steps: int = 2, quads: int = 2) -> dict:
    """Two small stage-1 steps (SMALL_AST over the real 1024x128 fbank, fusion
    width 64, float32, augmentation and dropout off) over ``quads`` global
    quads, this rank's rows; the fusion and decoder on the gathered stack."""
    import torch

    from amuse_tpu_torch.models.ast import ASTConfig, ASTDisentangler
    from amuse_tpu_torch.parallel import mesh as M
    from amuse_tpu_torch.train import audio as ta

    cfg = ta.AudioTrainConfig(learning_rate=TRAIN_LR)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        model = ASTDisentangler(ASTConfig(**SMALL_AST), fusion_dim=64).to(device)
    state = ta.AudioTrainState(model, ta.make_optimizer(model, cfg))
    M.replicate([model], mesh)
    step, _ = ta.make_train_step(cfg, None if mesh is None else M.GradSync(mesh))
    batch = M.shard_rows(_train_batch(quads, 1024, 128, 12, torch.device(device)), mesh)
    _reset_counts()
    t0, logs, grads = time.perf_counter(), [], []
    for i in range(steps):
        logs.append({k: v.item() for k, v in step(state, batch, None, stochastic=False).items()})
        grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()
                      if p.grad is not None})
        if i == 0:
            params_1 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    return {"logs": logs, "grads": grads, "params_1": params_1, "s": time.perf_counter() - t0,
            "rows": batch["fbanks"].shape[0],
            "launches": {**_launch_counts(), "ddim_sampler": _sampler_launches()},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}


def _dp_encode(mesh, device) -> dict:
    """``make_sharded_fbank`` and the sharded ``encode_audio`` (SMALL_AST
    encoders, random weights from a seed) over DP_CHUNKS chunks."""
    import torch

    from amuse_tpu_torch.audio.fbank import make_sharded_fbank
    from amuse_tpu_torch.data.cache import sharded_encoder
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig

    ast_cfg = ASTConfig(**SMALL_AST)
    prior_cfg, den_cfg = PriorConfig(**SMALL_PRIOR), DenoiserConfig(**SMALL_DENOISER)
    pipe = GesturePipeline(init_random_params(5, prior_cfg, den_cfg, ast_cfg), prior_cfg,
                           den_cfg, ast_cfg, dtype=torch.float32, device=device)
    chunks = _chunks(DP_CHUNKS, 6)
    _reset_counts()
    t0 = time.perf_counter()
    fbanks = make_sharded_fbank(mesh, device)(chunks)
    feats = sharded_encoder(pipe, mesh)(chunks)
    return {"fbank": torch.from_numpy(fbanks), "s": time.perf_counter() - t0,
            **{k: torch.from_numpy(v) for k, v in feats.items()},
            "launches": {**_launch_counts(), "ddim_sampler": _sampler_launches()}}


DP_BANK_ROWS = 128  # the synthetic stage-1 bank: 128 x (1024, 128) float32 = 64 MiB


def _write_bank_npz(path: Path) -> int:
    """A stage-1 npz whose bank is DP_BANK_ROWS fbanks -> the bank's bytes."""
    import numpy as np

    from amuse_tpu_torch.data import stage1

    rng = np.random.default_rng(40)
    bank = np.zeros((DP_BANK_ROWS, 1024, 128), np.float32)
    bank[:, :, :2] = rng.normal(size=(DP_BANK_ROWS, 1024, 2))
    split = {"fbank_bank": bank,
             "quad_idx": rng.integers(0, DP_BANK_ROWS, (96, 4)).astype(np.int32),
             **{k: rng.integers(0, 8, 96).astype(np.int32) for k in ("emo_id", "a1_id", "a2_id")}}
    stage1.save_dataset(path, split, {k: v[:2] for k, v in split.items()}, None)
    return bank.nbytes


def _dist_helpers():
    """tests/torch_port_dist.py (torch and the port only), imported from its
    directory: an installed package named ``tests`` may shadow it."""
    here = str(ROOT / "tests")
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_port_dist

    return torch_port_dist


def _dp_suite(mesh, device, npz: str | None = None) -> dict:
    out = {"lpdm": _dp_lpdm(mesh, device), "lpdm_dropout": _dp_lpdm(mesh, device, dropout=0.1),
           "stage1": _dp_stage1(mesh, device), "encode": _dp_encode(mesh, device)}
    if npz is not None:  # rank 0 unpacks, every rank maps; then the whole-npz read
        out["bank"] = _dist_helpers().stage1_bank(mesh, device, npz,
                                                  str(Path(npz).with_name("unpacked")))
    return out


def _gloo_rank(rank: int, world: int, init: str, out: str, npz: str) -> None:
    """A spawned rank of phase (b): gloo on the one card, the small suite."""
    import traceback

    sys.path.insert(0, str(ROOT))
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0")
    import torch

    from amuse_tpu_torch.parallel import mesh as M

    try:
        dev = M.initialize_distributed("cuda:0", backend="gloo", init_method=f"file://{init}")
        result = _dp_suite(M.make_mesh(), dev, npz)
        torch.save(result, Path(out) / f"rank{rank}.pt")
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def phase_distributed_gloo(world: int = 2) -> dict:
    """(b) Two gloo ranks sharing the card, spawned after the kernels are
    built: the small LPDM and stage-1 steps and the sharded fbank/encode,
    against one process on the card at the same global batch. Their times
    are two processes on one card, not a scaling number."""
    import multiprocessing

    import numpy as np
    import torch

    from amuse_tpu_torch.data import stage1

    tmp = tempfile.TemporaryDirectory()  # the ranks' parameters and gradients: ~280 MB
    out = Path(tmp.name)
    npz = out / "s1.npz"
    bank_bytes = _write_bank_npz(npz)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, world, str(out / "process_group"), str(out),
                                                  str(npz)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    errors = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            errors.append(f"rank {r} did not finish in 600 s")
        elif p.exitcode != 0:
            err = out / f"rank{r}.err"
            errors.append(err.read_text() if err.exists() else f"rank {r}: exit {p.exitcode}")
    check(not errors, "gloo ranks on the card failed:\n" + "\n".join(errors))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(world)]
    want_train, _ = stage1.load_dataset(npz)
    want_batch = next(stage1.batches(want_train, 2, np.random.default_rng(0)))
    del want_train
    tmp.cleanup()
    one = _dp_suite(None, "cuda")
    row = {"phase": "distributed_gloo_2_ranks_one_card", "world": world, "spawn_and_run_s": ranks_s,
           "note": "two processes share one card: times are not a scaling number"}
    for part in ("lpdm", "lpdm_dropout", "stage1"):
        a, b, w = ranks[0][part], ranks[1][part], one[part]
        check(all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"]),
              f"{part}: the ranks' parameters differ")
        err = [_dp_errors(r[part], w) for r in ranks]
        check(all(max(e["loss_rel_err"]) <= DP_LOSS_RTOL and e["grad_rel_err"] <= DP_GRAD_REL
                  and e["param_1_max_abs_err"] <= DP_PARAM_ATOL
                  and e["param_share_held"] >= DP_COVERED for e in err),
              f"{part}: two ranks against one process: {err}")
        row[part] = {"errors_per_rank": err, "loss_rtol": DP_LOSS_RTOL, "grad_rel": DP_GRAD_REL,
                     "param_1_atol": DP_PARAM_ATOL, "grad_floor": DP_GRAD_FLOOR,
                     "rows_per_rank": [r[part]["rows"] for r in ranks],
                     "launches_per_rank": [r[part]["launches"] for r in ranks],
                     "launches_one_process": w["launches"],
                     "s_per_rank": [r[part]["s"] for r in ranks], "s_one_process": w["s"]}
    # the bound (a quarter of the bank per rank) is held on the CPU
    # (tests/test_torch_port_orbax.py): under gVisor, which faults a mapped
    # file in whole and counts its pages as each mapping process's private
    # memory, the reading cannot show the sharing
    growth = [{k: r["bank"][f"{k}_growth"] for k in ("mapped", "npz")} for r in ranks]
    check(all(r["bank"]["mapped_is_memmap"] for r in ranks)
          and all(torch.equal(r["bank"][f"{k}_batch"][f], torch.from_numpy(want_batch[f]))
                  for r in ranks for k in ("mapped", "npz") for f in want_batch),
          "a rank's stage-1 arrays are not mapped, or its batch differs from the npz path's")
    row["stage1_bank"] = {"bank_bytes": bank_bytes, "private_growth_per_rank": growth,
                          "batches_bit_equal": True}
    check(all(r["lpdm"]["launches"]["ddim_sampler"] == 2 for r in ranks)
          and all(r["stage1"]["launches"]["attention_fwd"] == 2 * SMALL_AST["depth"]
                  and r["stage1"]["launches"]["attention_bwd"] == 2 * SMALL_AST["depth"]
                  for r in ranks),
          f"launches per rank: {[(r['lpdm']['launches'], r['stage1']['launches']) for r in ranks]}")
    enc = {}
    for k in ("fbank", "con", "emo", "sty"):
        errs = [max_err(r["encode"][k], one["encode"][k]) for r in ranks]
        enc[k] = {"max_abs_err": max(errs),
                  "bytes_equal": all(torch.equal(r["encode"][k], one["encode"][k]) for r in ranks)}
        check(max(errs) <= DP_FBANK_TOL, f"sharded {k}: {errs} against one call")
    row["encode"] = {**enc, "tolerance": DP_FBANK_TOL, "chunks": DP_CHUNKS,
                     "launches_per_rank": [r["encode"]["launches"] for r in ranks],
                     "s_per_rank": [r["encode"]["s"] for r in ranks],
                     "s_one_process": one["encode"]["s"]}
    emit(row)
    return row


def phase_distributed_cli(root: Path) -> dict:
    """(c) ``--fn train_gesture`` at tiny widths launched through
    ``LocalRunner.submit_multihost`` at world size 1 on ``--device cuda``
    (the rendered environment, NCCL), against a plain run in this process:
    the ``[distributed]`` line, and the same logged losses."""
    import numpy as np

    from amuse_tpu_torch.cluster.jobs import JobSpec, LocalRunner

    rng = np.random.default_rng(15)
    for actor_id, name in ((2, "scott"), (9, "miranda")):
        _write_take(root, actor_id, name, "0_9_9", 4, rng)
    log = OUT / "cli_distributed.log"

    def cfg(work: str) -> str:
        c = dict(TINY_CFG, out_dir=str(root / work / "runs"),
                 gesture={**TINY_CFG["gesture"], "epochs": 2, "batch_size": 4,
                          "model_save_freq": 1},
                 data={"data_root": str(root / "beat"), "mosh_root": str(root / "mosh"),
                       "cache_dir": str(root / "cache"), "stage1_dataset": str(root / "s1.npz"),
                       "smplx_model_dir": str(root / "none")})
        (root / f"{work}.json").write_text(json.dumps(c))
        return str(root / f"{work}.json")

    def rows(work: str) -> dict:
        run = sorted((root / work / "runs").iterdir())[-1]
        return {r["step"]: r for r in map(json.loads,
                                         (run / "metrics.jsonl").read_text().splitlines())}

    t0 = time.perf_counter()
    _run_cli(["--fn", "prepare_data", "--cfg", cfg("prep")], log, root)
    _run_cli(["--fn", "train_gesture", "--cfg", cfg("plain")], log, root)
    plain_s = time.perf_counter() - t0
    runner = LocalRunner(OUT / "distributed_jobs")
    spec = JobSpec("train_gesture_world1", [sys.executable, "-m", "amuse_tpu_torch.cli.main",
                                            "--fn", "train_gesture", "--cfg", cfg("world1"),
                                            "--device", "cuda"], workdir=str(root))
    t1 = time.perf_counter()
    rcs = runner.submit_multihost(spec, master=f"localhost:{_free_port()}",
                                  env={**os.environ, "PYTHONPATH": str(ROOT)})
    world1_s = time.perf_counter() - t1
    text = (OUT / "distributed_jobs" / "train_gesture_world1.r0.log").read_text()
    check(rcs == [0], f"world-1 train_gesture exited {rcs}:\n{text[-3000:]}")
    line = next((x for x in text.splitlines() if x.startswith("[distributed]")), "")
    check("process 0 of 1, 1 devices total (nccl, cuda:0)" in line,
          f"no [distributed] line of an NCCL world of 1: {line!r}")
    want, got = rows("plain"), rows("world1")
    keys = [k for k in want.get(1, {}) if k.startswith("train_")]
    diffs = [abs(got[e][k] - want[e][k]) / abs(want[e][k]) for e in (0, 1) for k in keys]
    check(sorted(got) == [0, 1] and keys and max(diffs) <= DP_CLI_RTOL,
          f"world-1 CLI losses {got} against the plain run's {want}")
    row = {"phase": "distributed_cli_world1", "distributed_line": line,
           "max_rel_diff": max(diffs), "tolerance": DP_CLI_RTOL, "plain_s": plain_s,
           "world1_s": world1_s, "epoch2": {k: got[1][k] for k in keys}}
    emit(row)
    return row


def run_distributed() -> dict:
    """The three data-parallel phases, the CLI's in a temporary directory."""
    # the card machine has no network: the ranks of one host talk over loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rows = {"world1": phase_distributed_world1(), "gloo": phase_distributed_gloo()}
    with tempfile.TemporaryDirectory() as tmp:
        rows["cli"] = phase_distributed_cli(Path(tmp))
    return rows


# ---- resuming a JAX run converted from its orbax checkpoints ----------------
#
# The JAX package's trees are built here from the port's own state dicts by
# the inverse of amuse_tpu_torch/convert.py's maps (tests/test_torch_port_orbax.py
# holds their layout against the JAX package's init trees on the CPU).
ORBAX_COUNT = 3  # the JAX optimizer's count: each parameter's step reads 4 after one step


def _flax_linear(sd: dict, prefix: str) -> dict:
    return {"kernel": sd[f"{prefix}.weight"].T.copy(), "bias": sd[f"{prefix}.bias"]}


def _flax_norm(sd: dict, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _flax_mha(sd: dict, prefix: str) -> dict:
    w, b = sd[f"{prefix}.in_proj_weight"], sd[f"{prefix}.in_proj_bias"]
    d = w.shape[1]
    out = {n: {"kernel": w[i * d:(i + 1) * d].T.copy(), "bias": b[i * d:(i + 1) * d]}
           for i, n in enumerate(("q_proj", "k_proj", "v_proj"))}
    out["out_proj"] = _flax_linear(sd, f"{prefix}.out_proj")
    return out


def _flax_layer(sd: dict, prefix: str) -> dict:
    out = {"self_attn": _flax_mha(sd, f"{prefix}.self_attn"),
           "ffn": {k: _flax_linear(sd, f"{prefix}.{k}") for k in ("linear1", "linear2")},
           "norm1": _flax_norm(sd, f"{prefix}.norm1"), "norm2": _flax_norm(sd, f"{prefix}.norm2")}
    if f"{prefix}.multihead_attn.in_proj_weight" in sd:
        out["cross_attn"] = _flax_mha(sd, f"{prefix}.multihead_attn")
        out["norm3"] = _flax_norm(sd, f"{prefix}.norm3")
    return out


def _flax_skip(sd: dict, prefix: str) -> dict:
    n = len({k.split(".")[2] for k in sd if k.startswith(f"{prefix}.input_blocks.")})
    out = {"mid": _flax_layer(sd, f"{prefix}.middle_block"), "norm": _flax_norm(sd, f"{prefix}.norm")}
    for i in range(n):
        out[f"in_{i}"] = _flax_layer(sd, f"{prefix}.input_blocks.{i}")
        out[f"out_{i}"] = _flax_layer(sd, f"{prefix}.output_blocks.{i}")
        out[f"skip_{i}"] = _flax_linear(sd, f"{prefix}.linear_blocks.{i}")
    return out


def flax_lpdm_tree(prior_sd: dict, den_sd: dict) -> dict:
    """The port's MotionPrior and Denoiser state dicts (numpy) -> the JAX
    package's ``{"prior", "denoiser"}`` parameter tree."""
    p, d = prior_sd, den_sd
    prior = {"encoder": {"dist_tokens": p["global_motion_token"],
                         "pos": {"pe": p["query_pos_encoder.pe"][:, 0]},
                         "skel_embedding": _flax_linear(p, "skel_embedding"),
                         "encoder": _flax_skip(p, "encoder")},
             "decoder": {"pos": {"pe": p["query_pos_decoder.pe"][:, 0]},
                         "decoder": _flax_skip(p, "decoder"),
                         "final_layer": _flax_linear(p, "final_layer")}}
    den = {"pos": {"pe": d["query_pos.pe"][:, 0]}, "encoder": _flax_skip(d, "encoder"),
           "time_mlp": {k: _flax_linear(d, f"time_embedding.{k}")
                        for k in ("linear_1", "linear_2")},
           **{f"proj_{n}": {"linear": _flax_linear(d, f"emb_proj_{n}.1")}
              for n in ("con", "emo", "sty")}}
    return {"prior": prior, "denoiser": den}


def _flax_ast_encoder(sd: dict, pre: str) -> dict:
    w = sd[f"{pre}.v.patch_embed.proj.weight"]  # (E, 1, p, p)
    out = {"patch_proj": {"kernel": w.reshape(w.shape[0], -1).T.copy(),
                          "bias": sd[f"{pre}.v.patch_embed.proj.bias"]},
           "cls_token": sd[f"{pre}.v.cls_token"], "dist_token": sd[f"{pre}.v.dist_token"],
           "pos_embed": sd[f"{pre}.v.pos_embed"], "norm": _flax_norm(sd, f"{pre}.v.norm"),
           "feature_ln": _flax_norm(sd, f"{pre}.feature_head.0"),
           "feature_fc": _flax_linear(sd, f"{pre}.feature_head.1")}
    if f"{pre}.mlp_head_featbased.0.weight" in sd:  # flax traces the frame-based branch
        out["featbased_ln"] = _flax_norm(sd, f"{pre}.mlp_head_featbased.0")
        out["featbased_fc"] = _flax_linear(sd, f"{pre}.mlp_head_featbased.1")
    depth = len({k.split(".")[3] for k in sd if k.startswith(f"{pre}.v.blocks.")})
    for i in range(depth):
        bp = f"{pre}.v.blocks.{i}"
        out[f"block_{i}"] = {"norm1": _flax_norm(sd, f"{bp}.norm1"),
                             "qkv": _flax_linear(sd, f"{bp}.attn.qkv"),
                             "attn_proj": _flax_linear(sd, f"{bp}.attn.proj"),
                             "norm2": _flax_norm(sd, f"{bp}.norm2"),
                             "mlp_fc1": _flax_linear(sd, f"{bp}.mlp.fc1"),
                             "mlp_fc2": _flax_linear(sd, f"{bp}.mlp.fc2")}
    return out


def flax_stage1_tree(sd: dict) -> dict:
    """The port's ASTDisentangler state dict (numpy) -> the JAX package's
    stage-1 parameter tree (the frame-based label heads, as flax traces them)."""

    def stack(prefix: str) -> dict:
        n = len({k.split(".")[2] for k in sd if k.startswith(f"{prefix}.layers.")})
        out = {f"layer_{i}": _flax_layer(sd, f"{prefix}.layers.{i}") for i in range(n)}
        out["norm"] = _flax_norm(sd, f"{prefix}.norm")
        return out

    tree = {f"{n}_enc": _flax_ast_encoder(sd, f"{n}_enc") for n in ("emo", "sty", "con")}
    for block in ("fusion", "fusion_ablation"):
        tree[block] = {**stack(block), "fc": _flax_linear(sd, f"{block}.fc")}
    tree["decoder"] = {**stack("decode"), "proj1": _flax_linear(sd, "decode.projection.0"),
                       "proj2": _flax_linear(sd, "decode.projection.2")}
    return tree


def jax_train_tree(params: dict, seed: int, lr: float) -> dict:
    """A template-free orbax restore of a JAX train state around ``params``:
    random moments (``nu`` positive), ``count`` ORBAX_COUNT, ``lr``, step 3."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def tree_map(fn, t):
        return {k: tree_map(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)

    def moment(x, second: bool):
        m = rng.standard_normal(x.shape, dtype=np.float32) * np.float32(1e-3)
        return m * m if second else m

    return {"params": params, "step": np.asarray(ORBAX_COUNT, np.int32),
            "opt_state": {"count": np.asarray(ORBAX_COUNT, np.int32),
                          "lr": np.asarray(lr, np.float32),
                          "mu": tree_map(lambda x: moment(x, False), params),
                          "nu": tree_map(lambda x: moment(x, True), params)}}


def _numpy_sd(module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def _resumed_step(make_state, converted: dict, step, batch, device: str, **kw) -> dict:
    """``converted`` loaded into the state of ``make_state(device)`` (-> the
    state and its parameters by name), one step on ``batch`` -> logs, the
    gradients, the parameters' change, each stepped Adam state's step and
    device, launches, and ms (host clock to a synchronise)."""
    import copy

    import torch

    state, params = make_state(device)
    # a copy: a CPU optimizer would keep (and step) the converted tensors themselves
    state.load_state_dict(copy.deepcopy(converted))
    before = {n: p.detach().cpu().clone() for n, p in params.items()}
    _reset_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = step(state, batch, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    opt_steps = {n: (state.optimizer.state[p]["step"].item(),
                     state.optimizer.state[p]["step"].device.type)
                 for n, p in params.items() if p.grad is not None}
    return {"logs": {k: v.item() for k, v in logs.items()}, "ms": ms,
            "grads": {n: p.grad.detach().cpu() for n, p in params.items() if p.grad is not None},
            "delta": {n: p.detach().cpu() - before[n] for n, p in params.items()},
            "opt_steps": opt_steps, "fused": state.optimizer.param_groups[0].get("fused"),
            "launches": {**_launch_counts(), "ddim_sampler": _sampler_launches()}}


def _resume_vs_cpu(name: str, make_state, converted, step, batch_fn, kw_fn, want: dict) -> dict:
    """The same converted state resumed on the card and on the CPU: one step
    each, held to the LPDM small-width tolerances (loss, step-1 gradients and
    the parameters' change, each relative L2)."""
    import torch

    runs = {dev: _resumed_step(make_state, converted, step, batch_fn(dev), dev, **kw_fn(dev))
            for dev in ("cpu", "cuda")}
    cpu, gpu = runs["cpu"], runs["cuda"]
    loss_err = max(abs(gpu["logs"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["logs"].items())
    grad_err = _grad_rel_l2(gpu["grads"], cpu["grads"])
    delta_err = _grad_rel_l2(gpu["delta"], cpu["delta"])
    steps = {s for s in gpu["opt_steps"].values()}
    check(gpu["logs"].keys() == cpu["logs"].keys() and loss_err <= LPDM_LOSS_RTOL
          and grad_err <= LPDM_GRAD_REL_L2 and delta_err <= LPDM_GRAD_REL_L2,
          f"{name}: resumed on the card vs the CPU: loss {loss_err}, gradients {grad_err}, "
          f"update {delta_err}")
    check(steps == {(ORBAX_COUNT + 1.0, "cuda")} and gpu["fused"] is True,
          f"{name}: Adam steps on the card {steps}, fused {gpu['fused']}; expected "
          f"{ORBAX_COUNT + 1} on cuda, fused")
    check(gpu["launches"] == want and all(v == 0 for v in cpu["launches"].values()),
          f"{name}: launches {gpu['launches']} on the card (expected {want}), "
          f"{cpu['launches']} on the CPU")
    return {"loss_rel_err": loss_err, "grad_rel_l2": grad_err, "update_rel_l2": delta_err,
            "loss_tolerance": LPDM_LOSS_RTOL, "grad_tolerance": LPDM_GRAD_REL_L2,
            "adam_steps": sorted(steps), "launches": gpu["launches"],
            "ms_card": gpu["ms"], "ms_cpu": cpu["ms"], "logs_card": gpu["logs"]}


def phase_orbax_resume() -> dict:
    """A JAX run resumed by the port from its converted train state (no JAX:
    the trees are built in the JAX package's layout from random weights and
    moments, ``count`` 3), through ``convert.gesture_train_state_from_jax`` /
    ``audio_train_state_from_jax`` into the train states on the card under
    fused AdamW / Adam:

      * the LPDM at the flagship widths (batch 32, the DDIM monitor, dropout
        off, the draws from a CPU generator): one step on the card against
        the same resume on the CPU; 1 K3 launch, each Adam ``step`` 4 on the
        card;
      * stage 1 at the small widths of ``phase_train_small_vs_cpu`` (float32):
        the same against the CPU, K1 and K2 once per ViT block;
      * stage 1 at the flagship widths (bf16 compute, 1 quad): the host
        seconds of mapping its 424.7 M parameters x 3 trees, and one
        resumed step on the card, timed, with 12 K1 + 12 K2."""
    import dataclasses

    import torch

    from amuse_tpu_torch import convert
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.models.ast import ASTConfig, ASTDisentangler
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.train import audio as ta
    from amuse_tpu_torch.train import gesture as tg

    t_phase = time.perf_counter()
    # the LPDM at the flagship widths
    prior_cfg, den_cfg = PriorConfig(dropout=0.0), DenoiserConfig(dropout=0.0)
    tcfg = tg.GestureTrainConfig()
    src = tg.init_state(31, prior_cfg, den_cfg, tcfg, "cpu")
    tree = jax_train_tree(flax_lpdm_tree(_numpy_sd(src.prior), _numpy_sd(src.denoiser)), 32,
                          tcfg.learning_rate)
    t0 = time.perf_counter()
    converted = convert.gesture_train_state_from_jax(tree, src)
    lpdm_map_s = time.perf_counter() - t0

    def lpdm_state(dev):
        s = tg.init_state(0, prior_cfg, den_cfg, tcfg, dev)
        return s, {**dict(s.prior.named_parameters("prior")),
                   **dict(s.denoiser.named_parameters("denoiser"))}

    lpdm_step = tg.make_train_step(prior_cfg, den_cfg, tcfg, None, True)
    noise = tg.draw_step_noise(torch.Generator().manual_seed(33), LPDM_BATCH, prior_cfg,
                               make_schedule(), torch.device("cpu"))
    lpdm = _resume_vs_cpu(
        "LPDM (flagship)", lpdm_state, converted, lpdm_step,
        lambda dev: _lpdm_batch(LPDM_BATCH, prior_cfg.window, den_cfg.cond_dim, 34,
                                torch.device(dev)),
        lambda dev: {"stochastic": False, "noise": tg.StepNoise(*(x.to(dev) for x in noise))},
        {"attention_fwd": 0, "attention_bwd": 0, "ddim_sampler": 1})
    lpdm.update(map_s=lpdm_map_s, params=sum(p.numel() for m in (src.prior, src.denoiser)
                                             for p in m.parameters()))

    # stage 1 at the small widths, float32
    cfg = ta.AudioTrainConfig(learning_rate=TRAIN_LR)

    def small_model():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(12)
            return ASTDisentangler(ASTConfig(**SMALL_AST), fusion_dim=64)

    src = small_model()
    tree = jax_train_tree(flax_stage1_tree(_numpy_sd(src)), 35, cfg.learning_rate)
    converted = convert.audio_train_state_from_jax(
        tree, ta.AudioTrainState(src, ta.make_optimizer(src, cfg)))

    def small_state(dev):
        m = small_model().to(dev)
        return ta.AudioTrainState(m, ta.make_optimizer(m, cfg)), dict(m.named_parameters())

    s1_step, _ = ta.make_train_step(cfg)
    depth = SMALL_AST["depth"]
    small = _resume_vs_cpu(
        "stage 1 (small)", small_state, converted, s1_step,
        lambda dev: _train_batch(1, 1024, 128, 36, torch.device(dev)),
        lambda dev: {"generator": None, "stochastic": False},
        {"attention_fwd": depth, "attention_bwd": depth, "ddim_sampler": 0})
    del src, converted, tree

    # stage 1 at the flagship widths: the mapping's host seconds, one resumed step
    ast_cfg = ASTConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(13)
        src = ASTDisentangler(ast_cfg)
    n_params = sum(p.numel() for p in src.parameters())
    tree = jax_train_tree(flax_stage1_tree(_numpy_sd(src)), 37, ta.lr_schedule(cfg, 0))
    del src
    with torch.device("meta"):
        meta = ASTDisentangler(ast_cfg)
    t0 = time.perf_counter()
    converted = convert.audio_train_state_from_jax(
        tree, ta.AudioTrainState(meta, ta.make_optimizer(meta, ta.AudioTrainConfig())))
    map_s = time.perf_counter() - t0
    del tree
    state = ta.init_state(0, ta.AudioTrainConfig(), torch.bfloat16, ast_cfg, "cuda")
    t0 = time.perf_counter()
    state.load_state_dict(converted)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del converted
    step, _ = ta.make_train_step(ta.AudioTrainConfig())
    batch = _train_batch(1, ast_cfg.input_tdim, ast_cfg.input_fdim, 38, torch.device("cuda"))
    _reset_counts()
    ms = []
    for i in range(3):  # the first resumed step, then two more
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = step(state, batch, ta.step_generator(0, 3, i, "cuda"))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v // 3 for k, v in _launch_counts().items()}
    steps = {(state.optimizer.state[p]["step"].item(), state.optimizer.state[p]["step"].device.type)
             for p in state.model.parameters() if p.grad is not None}
    check(launches == {"attention_fwd": ast_cfg.depth, "attention_bwd": ast_cfg.depth},
          f"flagship resumed stage-1 step: launches per step {launches}")
    check(all(math.isfinite(v.item()) for v in logs.values()),
          f"flagship resumed stage-1 step: non-finite logs {logs}")
    check(steps == {(ORBAX_COUNT + 3.0, "cuda")} and state.optimizer.param_groups[0]["fused"],
          f"flagship resumed stage-1 Adam steps {steps} (expected {ORBAX_COUNT + 3} on cuda)")
    del state
    torch.cuda.empty_cache()
    row = {"phase": "orbax_resume", "lpdm_flagship": lpdm, "stage1_small": small,
           "stage1_flagship": {"params": n_params, "map_s": map_s,
                               "map_note": "3 trees (params, mu, nu) and the permutation check",
                               "load_to_card_s": load_s, "ms_resumed_step": ms[0],
                               "ms_next_steps": ms[1:], "launches_per_step": launches,
                               "adam_steps_after_3": sorted(steps)},
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    return row


# The attention kernel variants (ops/kernel_variants.py, csrc/attention_variants_*.cu)
# are held to kernel_variants.kernel_limit and KERNEL_BIT_EQUAL_SHARE.
VARIANT_MAIN_ITERS = 10  # timed chain calls a leg in the entry point's run
# The variants' kernels and the library calls beside them are timed alike:
# the median of 5 CUDA-event windows of 20 back-to-back calls, after 10
# warm-up calls, the windows' spread beside it; and as device time, their
# kernels' times summed (``device_ms``), which the library's rows use: SDPA's
# bf16 backward on CUDA events read 0.17-0.85 ms from run to run, up to the
# time it takes on three times the work.
VARIANT_WINDOWS = {"windows": 5, "iters": 20, "warmup": 10}
# S x S x 64 products a kernel executes against those its function counts
# (v1, v0: a float32 operand's product is three bf16 products, one a piece)
VARIANT_PRODUCTS = {"softmax": (2, 3), "dots": (2, 2), "v4": (5, 9), "v1": (5, 15),
                    "v0": (5, 12)}


def cuda_ms_windows(fn, windows: int, iters: int, warmup: int) -> dict:
    """Device ms of fn() on CUDA events: the median over ``windows`` windows
    of ``iters`` back-to-back calls each, after ``warmup`` calls, and the
    windows' spread (least, largest)."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return {"ms": statistics.median(times), "spread_ms": [min(times), max(times)]}


def _variant_counts() -> dict:
    from amuse_tpu_torch.ops import kernel_variants as kv

    return {"variant_fwd": kv.variant_fwd.launches, "variant_bwd": kv.variant_bwd.launches,
            **_launch_counts(), "ddim_sampler": _sampler_launches()}


def phase_kernel_variants(ptxas: dict) -> list:
    """The attention kernel variants V1-V5 of benchmarks/kernel_variants.py.

    Each body's forward (softmax, dots) and backward (v1, v4, v0) kernel
    against its plain version at a small shape with a ragged S (2, 2, 333,
    64) in float32 and bf16 and at the harness's (4, 12, 1214, 64) bf16,
    under ``kernel_variants.kernel_limit``, each rerun bit-equal, a bf16
    forward (softmax, dots) bit-equal to its plain version on
    KERNEL_BIT_EQUAL_SHARE of its entries (K1's error and share against the
    plain softmax beside it, on the same inputs). At the harness shape each kernel is
    timed (VARIANT_WINDOWS) beside its plain version and SDPA's forward or
    backward in bf16 and float32; the redesigned kernels also as device
    time, the v4, v1 and v0 backwards' two kernels apart (``passes_ms``);
    their executed and counted TFLOP/s and ptxas's registers and spills
    (``ptxas``, from ``phase_build``). The v1 and v0 backwards also on
    ``kernel_variants.CANCELLATION_CASES`` at bf16 (their gradients small
    differences of large products), under the same limit, reruns
    bit-equal. Then
    the entry point ``kernel_variants.main`` (parity lines, the 12-call chain
    of the K1+K2 baseline and of each variant timed, one JSON line a leg),
    its launches counted against what its legs make; and one chain of each
    variant alone, counters at 0 before it: 12 forward and 12 backward
    launches, no K1, K2 or K3. -> the kernels line's rows of V1-V5."""
    import contextlib
    import io

    import torch
    import torch.nn.functional as F

    from amuse_tpu_torch.ops import attention
    from amuse_tpu_torch.ops import kernel_variants as kv

    def windows(fn) -> dict:
        t = cuda_ms_windows(fn, **VARIANT_WINDOWS)
        return {"ms": t["ms"], "ms_spread": t["spread_ms"]}

    product = 2.0 * kv.B * kv.H * kv.S * kv.S * kv.D

    def rates(name: str, ms: float, dev_ms: float) -> dict:
        """TFLOP/s on the windows' ms and (``device_*``) on the device ms."""
        counted, executed = VARIANT_PRODUCTS[name]
        return {"products_counted": counted, "products_executed": executed, "device_ms": dev_ms,
                "tflops_counted": counted * product / ms / 1e9,
                "tflops_executed": executed * product / ms / 1e9,
                "device_tflops_counted": counted * product / dev_ms / 1e9,
                "device_tflops_executed": executed * product / dev_ms / 1e9}

    def check_grads(at, got, refs, again, body) -> dict:
        grads = {}
        for what, x, ref, y in zip(("dq", "dk", "dv"), got, refs, again):
            err, top = max_err(x, ref), ref.float().abs().max().item()
            tol, err_l2 = kv.kernel_limit(x.dtype, body, top), rel_l2(x, ref)
            check(torch.isfinite(x.float()).all().item(), f"{at}, {what}: not finite")
            check(err <= tol, f"{at}, {what} disagrees with its plain version: {err} > {tol}")
            check(body != "v4" or err_l2 <= kv.KERNEL_V4_REL_L2,
                  f"{at}, {what}: relative L2 error {err_l2} > {kv.KERNEL_V4_REL_L2}")
            check(torch.equal(x, y), f"{at}, {what}: two launches differ")
            grads[what] = {"max_abs_err": err, "tolerance": tol, "rel_l2_err": err_l2}
        return {"grads": grads, "max_abs_err": max(c["max_abs_err"] for c in grads.values()),
                "err_over_tolerance": max(c["max_abs_err"] / c["tolerance"]
                                          for c in grads.values())}

    g = torch.Generator(device="cuda").manual_seed(12)
    cases, at_shape = [], {}
    for dtype, shape in ((torch.float32, (2, 2, 333, 64)), (torch.bfloat16, (2, 2, 333, 64)),
                         (torch.bfloat16, (kv.B, kv.H, kv.S, kv.D))):
        name = str(dtype).replace("torch.", "")
        harness = shape == (kv.B, kv.H, kv.S, kv.D)
        q, k, v, do = ((torch.randn(shape, generator=g, device="cuda") * (0.5 if i < 3 else 1.0))
                       .to(dtype) for i in range(4))
        for body in kv.FWD_BODIES:
            run = functools.partial(kv.variant_fwd, q, k, v, body)
            out, again = run(), run()
            ref = kv.variant_fwd_reference(q, k, v, body)
            torch.cuda.synchronize()
            err, top = max_err(out, ref), ref.float().abs().max().item()
            tol = kv.kernel_limit(dtype, body, top)
            at = f"variant forward {body} at {shape} {name}"
            check(torch.isfinite(out.float()).all().item(), f"{at}: output not finite")
            check(err <= tol, f"{at} disagrees with its plain version: {err} > {tol}")
            check(torch.equal(out, again), f"{at}: two launches differ")
            case = {"kernel": "forward", "body": body, "shape": list(shape), "dtype": name,
                    "max_abs_err": err, "tolerance": tol}
            if dtype == torch.bfloat16:  # e or s rounded where the TPU bodies round it
                case["bit_equal_share"] = share = kv.bit_equal_share(out, ref)
                check(share >= kv.KERNEL_BIT_EQUAL_SHARE,
                      f"{at}: bit-equal on a share {share} < {kv.KERNEL_BIT_EQUAL_SHARE} "
                      "of its entries")
            if harness:
                if body == "softmax":  # K1 on the same inputs: e rounded against a running max
                    k1 = attention.mha(q, k, v)
                    case.update(k1_max_abs_err=max_err(k1, ref),
                                k1_bit_equal_share=kv.bit_equal_share(k1, ref))
                    del k1
                case.update(windows(run),
                            plain_ms=cuda_ms(lambda: kv.variant_fwd_reference(q, k, v, body),
                                             iters=3, warmup=1))
                if body in VARIANT_PRODUCTS:
                    kernel = f"{body}_fwd_wgmma"
                    case.update(rates(body, case["ms"], sum(_kernel_times(run, kernel).values())),
                                ptxas={n: x for n, x in ptxas.items() if kernel in n})
                at_shape[body] = case
            cases.append(case)
            del out, again, ref
        for body in kv.BWD_BODIES:
            run = functools.partial(kv.variant_bwd, q, k, v, do, body)
            got, again = run(), run()
            refs = kv.variant_bwd_reference(q, k, v, do, body)
            torch.cuda.synchronize()
            at = f"variant backward {body} at {shape} {name}"
            case = {"kernel": "backward", "body": body, "shape": list(shape), "dtype": name,
                    **check_grads(at, got, refs, again, body)}
            if harness:
                case.update(windows(run),
                            plain_ms=cuda_ms(lambda: kv.variant_bwd_reference(q, k, v, do, body),
                                             iters=3, warmup=1))
                if body in VARIANT_PRODUCTS:  # each body's rows and columns kernels
                    passes = _kernel_times(run, f"{body}_")
                    case.update(rates(body, case["ms"], sum(passes.values())), passes_ms=passes,
                                ptxas={n: x for n, x in ptxas.items() if f"{body}_" in n})
                at_shape[body] = case
            cases.append(case)
            del got, again, refs
        if harness:  # SDPA on the same work, in bf16 and in float32
            library = {}
            for lib_name, cast in (("bfloat16", dtype), ("float32", torch.float32)):
                lq, lk, lv = (t.to(cast).detach().clone().requires_grad_() for t in (q, k, v))
                lib_out = F.scaled_dot_product_attention(lq, lk, lv)
                ldo = do.to(cast)
                fwd_fn = functools.partial(F.scaled_dot_product_attention, lq, lk, lv)
                bwd_fn = functools.partial(torch.autograd.grad, lib_out, (lq, lk, lv), ldo,
                                           retain_graph=True)
                fwd, bwd = (cuda_ms_windows(f, **VARIANT_WINDOWS) for f in (fwd_fn, bwd_fn))
                library[lib_name] = {
                    "forward_ms": device_ms(fwd_fn), "forward_window_ms": fwd["ms"],
                    "forward_spread_ms": fwd["spread_ms"], "backward_ms": device_ms(bwd_fn),
                    "backward_window_ms": bwd["ms"], "backward_spread_ms": bwd["spread_ms"]}
                del lq, lk, lv, lib_out, ldo
        del q, k, v, do
    for body, names in kv.CANCELLATION_CASES.items():  # the bf16 splits' cases
        for name in names:
            q, k, v, do = (t.cuda() for t in kv.cancellation_inputs(name))
            run = functools.partial(kv.variant_bwd, q, k, v, do, body)
            got, again = run(), run()
            refs = kv.variant_bwd_reference(q, k, v, do, body)
            torch.cuda.synchronize()
            at = f"variant backward {body} on the cancellation case {name!r}"
            cases.append({"kernel": "backward", "body": body, "cancellation": name,
                          "shape": list(q.shape), "dtype": "bfloat16",
                          "targets": kv.CANCELLATION_TARGETS[name],
                          **check_grads(at, got, refs, again, body)})
            del q, k, v, do, got, again, refs
    torch.cuda.empty_cache()

    # the entry point, as a user runs it, every counter at 0 before it
    _reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rows = kv.main(["--iters", str(VARIANT_MAIN_ITERS)])
    main_s = time.perf_counter() - t0
    counts = _variant_counts()
    printed = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    calls = (2 + VARIANT_MAIN_ITERS) * kv.CHAIN_CALLS  # cuda_ms: 2 warm-up calls
    want = {"variant_fwd": 6 + 1 + len(kv.VARIANTS) * calls,
            "variant_bwd": 3 + len(kv.VARIANTS) * calls,
            "attention_fwd": calls, "attention_bwd": calls, "ddim_sampler": 0}
    check(printed == rows and len(rows) == 4 + 1 + len(kv.VARIANTS),
          f"kernel_variants.main printed {len(printed)} lines, returned {len(rows)}")
    check(counts == want, f"kernel_variants.main launches {counts}, expected {want}")
    legs = {r["leg"]: r["ms"] for r in rows if "leg" in r}
    parity = {k: v for r in rows for k, v in r.items() if k.endswith("_dev") or k == "grad_scale"}
    check(all(math.isfinite(x) for x in [*legs.values(), *parity.values()]),
          f"kernel_variants.main: non-finite numbers {legs} {parity}")

    # one chain of each variant alone: what a TPU kernel's row counts
    x = (torch.randn((kv.B, kv.H, kv.S, kv.D), generator=g, device="cuda") * 0.05).to(
        torch.bfloat16)
    per_chain = {}
    for name in kv.VARIANTS:
        _reset_counts()
        loss, grad = kv.chain(kv.make_variant(name))(x)
        torch.cuda.synchronize()
        per_chain[name] = _variant_counts()
        check(per_chain[name] == {"variant_fwd": 12, "variant_bwd": 12, "attention_fwd": 0,
                                  "attention_bwd": 0, "ddim_sampler": 0},
              f"one {name} chain launched {per_chain[name]}")
        check(math.isfinite(loss.item()) and torch.isfinite(grad.float()).all().item(),
              f"{name} chain: non-finite loss or gradient")
    emit({"phase": "kernel_variants", "cases": cases, "library": library,
          "main": {"seconds": main_s, "iters": VARIANT_MAIN_ITERS, "launches": counts,
                   "chain_ms": legs, "parity": parity},
          "launches_per_chain": per_chain})

    # Bounds at the harness shape (bf16 inputs). Each S x S x 64 product is
    # charged at the bf16 tensor-core peak: bf16 x bf16 (q k^T, dO v^T, the
    # bf16-rounded e, ds16 and e / r against a bf16 tensor) once, a float32
    # operand against an exact bf16 one (v1's ds and e / r, with dp = dO v^T
    # / r; v0's ds and s) three times, its three bf16 pieces. body -> (bf16
    # products, float32 products, bf16 bytes moved)
    b, h, s, d = kv.B, kv.H, kv.S, kv.D
    product, tensor = 2.0 * b * h * s * s * d, b * h * s * d * 2.0
    work = {"softmax": (2, 0, 4 * tensor), "dots": (2, 0, 4 * tensor),
            "v1": (11, 0, 7 * tensor), "v4": (5, 0, 7 * tensor), "v0": (11, 0, 7 * tensor)}

    def bound(body):
        n_bf16, n_f32, nbytes = work[body]
        ops_s = product * (n_bf16 / PEAK_BF16_FLOPS + n_f32 / PEAK_F32_FLOPS)
        return {"bound_ms": max(ops_s, nbytes / PEAK_BYTES) * 1e3,
                "bound_by": "operations" if ops_s > nbytes / PEAK_BYTES else "bytes"}

    def timing(body, lib):
        """The body's row; ``lib`` names SDPA's time where SDPA computes the
        body's function (softmax attention), None where no PyTorch call does
        (the dots forward, the v0 backward)."""
        c = at_shape[body]
        extra = {k: c[k] for k in ("tolerance", "err_over_tolerance", "grads", "bit_equal_share",
                                   "ms_spread", "device_ms", "passes_ms", "products_counted",
                                   "products_executed", "tflops_counted", "tflops_executed",
                                   "device_tflops_counted", "device_tflops_executed",
                                   "ptxas") if k in c}
        row = {"body": body, "shape": c["shape"], "dtype": c["dtype"],
               "max_abs_err": c["max_abs_err"], **extra, "ms": c["ms"],
               "plain_ms": c["plain_ms"], "library_ms": None}
        if lib is not None:
            row.update(library_ms=library["bfloat16"][lib],
                       library_window_ms=library["bfloat16"][lib.replace("_ms", "_window_ms")],
                       library_spread_ms=library["bfloat16"][lib.replace("_ms", "_spread_ms")],
                       library_f32_ms=library["float32"][lib])
        return {**row, **bound(body)}

    def launches(kind, names):
        return sum(per_chain[n][kind] for n in names)

    fwd_src = {"route": "cuda", "source": "amuse_tpu_torch/csrc/attention_variants_fwd.cu"}
    bwd_src = {"route": "cuda", "source": "amuse_tpu_torch/csrc/attention_variants_bwd.cu"}
    softmax = timing("softmax", "forward_ms")
    softmax.update({k: at_shape["softmax"][k] for k in ("k1_max_abs_err", "k1_bit_equal_share")})
    v1_bwd = timing("v1", "backward_ms")
    kernels = [
        {"name": "attention_variants_fwd (V1 _call_fwd)", **fwd_src,
         "replaces": "benchmarks/kernel_variants.py:120",
         "launches": launches("variant_fwd", ("v1_divfold", "v0_dotsonly", "v4_bf16dots")),
         "launches_per": "one 12-call chain each of v1_divfold, v0_dotsonly, v4_bf16dots",
         **softmax, "dots": timing("dots", None)},
        {"name": "attention_variants_bwd (V2 _call_bwd)", **bwd_src,
         "replaces": "benchmarks/kernel_variants.py:143",
         "launches": launches("variant_bwd", ("v1_divfold", "v0_dotsonly", "v4_bf16dots",
                                              "v5_fullq_fwd")),
         "launches_per": "one 12-call chain each of v1_divfold, v0_dotsonly, v4_bf16dots, "
                         "v5_fullq_fwd",
         **v1_bwd, "v4": timing("v4", "backward_ms"), "v0": timing("v0", None)},
        {"name": "attention_variants_fwd (V3 _call_fwd_v3)", **fwd_src,
         "replaces": "benchmarks/kernel_variants.py:373",
         "launches": launches("variant_fwd", ("v3_headloop",)),
         "launches_per": "one 12-call chain of v3_headloop", **softmax},
        {"name": "attention_variants_bwd (V4 _call_bwd_v3)", **bwd_src,
         "replaces": "benchmarks/kernel_variants.py:393",
         "launches": launches("variant_bwd", ("v3_headloop",)),
         "launches_per": "one 12-call chain of v3_headloop", **v1_bwd},
        {"name": "attention_variants_fwd (V5 make_v5.call_fwd)", **fwd_src,
         "replaces": "benchmarks/kernel_variants.py:441",
         "launches": launches("variant_fwd", ("v5_fullq_fwd",)),
         "launches_per": "one 12-call chain of v5_fullq_fwd", **softmax},
    ]
    for row in kernels:
        row["chain_ms"] = legs
    return kernels



def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke test and measurement of the "
                                                 "PyTorch/CUDA port on one NVIDIA GPU.")
    parser.add_argument("--only-k1", action="store_true",
                        help="build the kernels, run only the K1 phase and print no result "
                             "line (to time K1 of two checkouts on one card)")
    parser.add_argument("--only-k2", action="store_true",
                        help="the same for the K2 phase; with --only-k1, both")
    parser.add_argument("--only-k3", action="store_true",
                        help="the same for K3's timing at N = 1, 4, 8 and 32 (also runs in a "
                             "checkout from before the cluster kernel)")
    parser.add_argument("--only-wav-to-motion", action="store_true",
                        help="the same for wav_to_motion at the flagship widths with its trace")
    parser.add_argument("--only-train-step", action="store_true",
                        help="the same for the flagship train step with its trace (host "
                             "enqueue and device time of two checkouts on one card)")
    parser.add_argument("--only-edit", action="store_true",
                        help="the same for checkpoint_load and edit_gesture at the flagship "
                             "widths")
    parser.add_argument("--only-prepare-data", action="store_true",
                        help="the same for prepare_data's frozen-AST pass and stage-1 quads "
                             "at the flagship AST widths")
    parser.add_argument("--only-train-gesture", action="store_true",
                        help="the same for the three LPDM phases: small widths against the "
                             "CPU, the flagship step, the train_gesture CLI")
    parser.add_argument("--only-eval", action="store_true",
                        help="the same for eval_gesture at the flagship widths, the "
                             "embedder's train step and the native ABIN loader")
    parser.add_argument("--only-host-tasks", action="store_true",
                        help="the same for bvh2smplx_, render_gt, render_baselines, "
                             "blender_setup and infer_gesture's render wiring")
    parser.add_argument("--only-legacy", action="store_true",
                        help="the same for the legacy zoo and MFCC + DTW: small widths "
                             "against the CPU, the raw-diffusion step and samplers, MFCC and "
                             "DTW, every member's forward at its default widths")
    parser.add_argument("--only-distributed", action="store_true",
                        help="the same for data parallelism: NCCL at world size 1 (the "
                             "flagship stage-1 and LPDM steps with and without the gradient "
                             "sync), two gloo ranks on the card against one process, the "
                             "train_gesture CLI launched through cluster/jobs.py")
    parser.add_argument("--only-orbax", action="store_true",
                        help="the same for a JAX run's converted train state resumed on the "
                             "card: the flagship LPDM and small stage-1 against the CPU, the "
                             "flagship stage-1 mapping's host seconds and resumed step")
    parser.add_argument("--only-kernel-variants", action="store_true",
                        help="the same for the attention kernel variants V1-V5: each body's "
                             "forward and backward kernel against its plain version, the "
                             "entry point kernel_variants.main, one chain of each variant")
    parser.add_argument("--train-steps", type=int, default=4,
                        help="timed steps of the flagship train step (default 4)")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "amuse_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no amuse_tpu_torch/ beside {Path(__file__).name}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from amuse_tpu_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off for matmuls and cuDNN
    # the CPU references below: a process's first parallel float32 sqrt on the
    # CPU can compute one worker's share imprecisely (seen with torch 2.13.0+cpu:
    # one eighth of it off by up to 2.4e-4 relative), so one runs first
    torch.ones(1 << 22).sqrt_()
    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})
    ptxas = phase_build()
    if (args.only_k1 or args.only_k2 or args.only_k3 or args.only_wav_to_motion
            or args.only_train_step or args.only_edit or args.only_prepare_data
            or args.only_train_gesture or args.only_eval or args.only_host_tasks
            or args.only_legacy or args.only_distributed or args.only_orbax
            or args.only_kernel_variants):
        if args.only_k1:
            phase_attention()
        if args.only_k2:
            phase_attention_k2()
        if args.only_k3:
            phase_k3_timing()
        if args.only_wav_to_motion:
            phase_main_path()
        if args.only_train_step:
            phase_train_step(args.train_steps)
        if args.only_edit or args.only_prepare_data:
            both = args.only_edit and args.only_prepare_data
            run_edit_and_prepare("edit" if args.only_edit else "prepare", with_prepare=both)
        if args.only_train_gesture:
            run_train_gesture()
        if args.only_eval:
            run_eval()
        if args.only_host_tasks:
            run_host_tasks()
        if args.only_legacy:
            phase_legacy(smi)
        if args.only_distributed:
            run_distributed()
        if args.only_orbax:
            phase_orbax_resume()
        if args.only_kernel_variants:
            phase_kernel_variants(ptxas)
        emit({"phase": "profiler", **PROFILER})
        return 0
    # the attention variants first: after the legacy phase the first profiler
    # session of each of their kernels and library calls came back short
    # (``_profile`` runs it again); here every session comes back whole
    variants = phase_kernel_variants(ptxas)
    k1_cases = phase_attention()
    k1, k1_take = k1_cases[(3, 12, 1214, 64)], k1_cases[(3 * EDIT_WINDOWS, 12, 1214, 64)]
    k3 = phase_sampler()
    phase_small_reference()
    launches = phase_main_path()
    phase_cli()
    k2 = phase_attention_k2()
    phase_train_small_vs_cpu()
    train_launches = phase_train_step(args.train_steps)
    phase_cli_train()
    edit_rows = run_edit_and_prepare()
    lpdm = run_train_gesture()
    phase_orbax_resume()
    evals = run_eval()
    host = run_host_tasks()
    phase_legacy(smi)
    dp = run_distributed()
    kernels = [
        {"name": "attention_fwd", "route": "cuda",
         "source": "amuse_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "amuse_tpu/ops/attention.py:247", "shape": k1["shape"],
         "launches": launches["attention_fwd"], "max_abs_err": k1["max_abs_err"],
         "tolerance": k1["tolerance"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "ddim_sampler", "route": "cuda",
         "source": "amuse_tpu_torch/csrc/ddim_sampler.cu",
         "replaces": "amuse_tpu/ops/denoiser_kernel.py:313", "windows": k3["windows"],
         "cluster": k3["cluster"],
         "launches": launches["ddim_sampler"], "max_abs_err": k3["max_abs_err"],
         "tolerance": k3["tolerance"], "ms": k3["ms"], "ms_per_step": k3["ms_per_step"],
         "wrapper_ms": k3["wrapper_ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
        {"name": "attention_bwd", "route": "cuda",
         "source": "amuse_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "amuse_tpu/ops/attention.py:289", "shape": k2["shape"],
         "launches": train_launches["attention_bwd"], "launches_per": "train step",
         "max_abs_err": k2["max_abs_err"],
         "tolerance": k2["tolerance"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"]},
    ]
    kernels[0]["launches_per"] = "wav_to_motion call"
    kernels[1]["launches_per"] = "wav_to_motion call"
    kernels[0]["launches_per_train_step"] = train_launches["attention_fwd"]
    prep = edit_rows["prepare"]
    kernels[0]["launches_per_encode"] = prep["launches"]["attention_fwd"] // prep["takes"]
    kernels[0]["launches_emotion_control"] = edit_rows["edit"]["launches"]["attention_fwd"]
    kernels[0]["take_of_6_windows"] = {k: k1_take[k] for k in (
        "shape", "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "tflops", "bound_share")}
    edit = edit_rows["edit"]
    kernels[1]["launches_per_edit_variant"] = edit["launches"]["ddim_sampler"] / edit["variants"]
    kernels[1]["launches_emotion_control"] = edit["launches"]["ddim_sampler"]
    step = lpdm["step"]
    kernels[1]["launches_per_monitored_lpdm_step"] = step["monitored"]["k3_launches_per_step"]
    kernels[1]["launches_per_unmonitored_lpdm_step"] = step["unmonitored"]["k3_launches_per_step"]
    kernels[1]["lpdm_step_n32"] = {k: step["k3_n32"][k] for k in (
        "windows", "cluster", "max_abs_err", "tolerance", "ms", "wrapper_ms", "plain_ms",
        "bound_ms", "bound_by")}
    ev = evals["eval"]
    kernels[1]["launches_eval_gesture"] = ev["k3_launches"]
    kernels[1]["launches_eval_gesture_per"] = f"evaluate_cache over {ev['windows']} windows"
    kernels[1]["eval_tail"] = ev["k3_tail"]
    for i, name in ((0, "attention_fwd"), (1, "ddim_sampler")):
        kernels[i]["launches_infer_cli_with_render_wiring"] = host["launches_per_infer_cli"][name]
    # data parallelism: per step at world size 1 (NCCL), per rank of two gloo ranks
    for k in kernels:
        name = k["name"]
        k["launches_per_world1_step"] = {part: dp["world1"][part]["launches_per_step"][name]
                                         for part in ("stage1", "lpdm")}
        k["launches_per_gloo_rank"] = {part: [r[name] for r in dp["gloo"][part]["launches_per_rank"]]
                                       for part in ("lpdm", "stage1", "encode")}
    kernels += variants
    check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite kernel time")
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the main paths never launched")
    (OUT / "kernels.json").write_text(json.dumps({"kernels": kernels, "nvidia_smi": smi,
                                                  "seconds": time.perf_counter() - t_start},
                                                 indent=1))
    emit({"phase": "profiler", **PROFILER})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
