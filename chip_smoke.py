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
  * evaluation: ``evaluate_cache`` over 100 windows at the flagship widths
    (K3 once per batch of 32, the tail of 4 included) against its small-width
    run on the CPU; the external embedder's train step; the native ABIN
    loader through the pinned prefetch, and ``train_gesture`` fed by it.

Each phase prints one JSON line as it ends; after the ``{"kernels": [...]}``
line and the card's ``name, power.limit`` line, the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero. Without CUDA, or outside a checkout,
it exits non-zero before printing any result. Imports no JAX. Logs go to
``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import argparse
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


def phase_build():
    from amuse_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build()
    seconds = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    log = "\n".join(f"== {name}.cu ({r['seconds']:.1f} s)\n{r['log']}" for name, r in results.items())
    (OUT / "build.log").write_text(log)
    ptxas, faults, kernel = [], [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = _kernel_name(ln)
        elif "registers" in ln:
            ptxas.append(f"{kernel}: {ln.split(':', 1)[1].strip()}")
        elif "spill stores" in ln and any(k in kernel for k in CLEAN_KERNELS) and any(
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


def trace_call(fn, name: str) -> dict:
    """Device time by kernel for one call of fn() (torch.profiler, CUPTI):
    the call's host wall time (the profiler's overhead included), the device
    busy time, launches and the longest kernels. The Chrome trace goes to
    ``OUT / "<name>_trace.json"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    prof.export_chrome_trace(str(OUT / f"{name}_trace.json"))
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
    beside the SDPA backward, whole and pass by pass (``passes_ms``)."""
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
                        passes_ms=_kernel_times(lambda: mha_bwd(q, k, v, out, do, lse), "attn_bwd"))
        cases.append(case)
    emit({"phase": "attention_k2", "cases": cases})
    return cases[-1]


def _kernel_times(fn, mark: str, calls: int = 5) -> dict:
    """Mean device ms per call of each kernel whose name holds ``mark``,
    over ``calls`` calls of fn() (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {r["kernel"][r["kernel"].find(mark):].split("(")[0]: r["ms"] / calls
            for r in _device_rows(prof) if mark in r["kernel"]}


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
    from amuse_tpu_torch.ops import attention, denoiser_kernel

    attention.mha.launches = attention.mha_bwd.launches = 0
    denoiser_kernel.ddim_sample_fused.launches = 0


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
    """Device time by kernel for one train step (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from amuse_tpu_torch.train.audio import step_generator

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, step_generator(0, 0, 99, "cuda"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, families = _device_rows(prof), {}
    for r in rows:
        family = next((f for f, marks in _KERNEL_FAMILIES if any(m in r["kernel"] for m in marks)),
                      "other elementwise and reductions")
        families[family] = families.get(family, 0.0) + r["ms"]
    prof.export_chrome_trace(str(OUT / "train_step_trace.json"))
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
    per_take = stage1.fbanks_per_take(takes, stage1.device_fbank_fn("cuda"))
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
    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})
    phase_build()
    if (args.only_k1 or args.only_k2 or args.only_k3 or args.only_wav_to_motion
            or args.only_train_step or args.only_edit or args.only_prepare_data
            or args.only_train_gesture or args.only_eval):
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
        return 0
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
    evals = run_eval()
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
    check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite kernel time")
    (OUT / "kernels.json").write_text(json.dumps({"kernels": kernels, "nvidia_smi": smi,
                                                  "seconds": time.perf_counter() - t_start},
                                                 indent=1))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
