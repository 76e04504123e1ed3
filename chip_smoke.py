#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Builds the port's CUDA kernels from ``amuse_tpu_torch/csrc`` (one nvcc per
source, in parallel), holds each kernel against its plain PyTorch version at
the shapes the main path gives it, drives the main path
(``GesturePipeline.wav_to_motion`` at the flagship widths with random
weights, then the ``infer_gesture`` CLI) and checks that it went through the
kernels by their launch counters. Each phase prints one JSON line as it
ends; after the ``{"kernels": [...]}`` line and the card's
``name, power.limit`` line, the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero. Without CUDA, or outside a checkout,
it exits non-zero before printing any result. Imports no JAX. Logs go to
``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import os
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
K3_TOL = 2e-3  # 50 float32 steps (tests/test_denoiser_kernel.py:47)
K3_TOL_STEP = 2e-4  # one step (tests/test_denoiser_kernel.py:68)
PIPE_TOL = 1e-3  # small-width pipeline, kernels vs plain, float32


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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def phase_build():
    from amuse_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build()
    seconds = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    log = "\n".join(f"== {name}.cu ({r['seconds']:.1f} s)\n{r['log']}" for name, r in results.items())
    (OUT / "build.log").write_text(log)
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "sources": {n: r["seconds"] for n, r in results.items()}, "ptxas": ptxas})


def phase_attention(rng_seed: int = 0) -> dict:
    """K1 against mha_reference at the AST shape (strided views of the fused
    qkv output, as vit_block feeds it) and at ragged S = 70."""
    import torch
    import torch.nn.functional as F

    from amuse_tpu_torch.ops.attention import mha, mha_reference

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    cases = []
    for dtype, b, h, s, d, tol in ((torch.float32, 1, 2, 70, 32, K1_TOL_F32),
                                   (torch.float32, 2, 2, 70, 64, K1_TOL_F32),
                                   (torch.bfloat16, 1, 2, 70, 32, K1_TOL),
                                   (torch.bfloat16, 3, 12, 1214, 64, K1_TOL),
                                   (torch.bfloat16, 12, 12, 1214, 64, K1_TOL)):
        qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = mha(q, k, v)
        ref = mha_reference(q, k, v)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(out.shape == ref.shape and torch.isfinite(out.float()).all().item(),
              f"K1 output bad at {(b, h, s, d, str(dtype))}")
        check(err <= tol, f"K1 disagrees with its plain version at {(b, h, s, d)} {dtype}: "
                          f"{err} > {tol}")
        case = {"shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "tolerance": tol}
        if s == 1214:
            flops = 4.0 * b * h * s * s * d
            nbytes = 4.0 * b * h * s * d * q.element_size()  # q, k, v read, o written
            case.update(
                ms=cuda_ms(lambda: mha(q, k, v)),
                plain_ms=cuda_ms(lambda: mha_reference(q, k, v)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
                else "bytes",
            )
        cases.append(case)
    emit({"phase": "attention_k1", "cases": cases})
    return next(c for c in cases if c["shape"] == [3, 12, 1214, 64])


def _sampler_flops(n: int, steps: int, t: int, d: int, ff: int, layers: int) -> float:
    per_layer = 2 * t * (4 * d * d + 2 * d * ff) + 4 * t * t * d
    per_step = layers * per_layer + ((layers - 1) // 2) * 2 * t * 2 * d * d
    return float(n * steps * per_step)


def phase_sampler() -> dict:
    """K3 against the plain DDIM loop at the flagship denoiser dims."""
    import torch

    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from amuse_tpu_torch.ops.denoiser_kernel import (
        ddim_sample_fused,
        ddim_sample_reference,
        launch_sampler,
        pack_denoiser,
        precompute_conditioning,
    )

    torch.manual_seed(0)
    cfg = DenoiserConfig()
    den = Denoiser(cfg).cuda().eval()
    sched = make_schedule()
    packed = pack_denoiser(den)
    g = torch.Generator(device="cuda").manual_seed(1)
    weight_bytes = sum(t.numel() * 4 for t in packed)
    cases = []
    for n, steps, streams, tol in ((1, 1, 3, K3_TOL_STEP), (2, 50, 1, K3_TOL),
                                   (1, 50, 3, K3_TOL), (8, 50, 3, K3_TOL)):
        con, emo, sty = (torch.randn((n, cfg.cond_dim), generator=g, device="cuda")
                         for _ in range(3))
        emo, sty = (emo, sty) if streams == 3 else (None, None)
        x0 = torch.randn((n, 1, cfg.latent_dim), generator=g, device="cuda")
        run = lambda: ddim_sample_fused(den, sched, con, emo, sty, steps,  # noqa: E731
                                        initial_latents=x0, packed=packed)
        plain = lambda: ddim_sample_reference(den, sched, con, emo, sty, x0, steps)  # noqa: E731
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(torch.isfinite(out).all().item(), f"K3 output not finite at N={n}")
        check(err <= tol, f"K3 disagrees with its plain loop at N={n}, {steps} steps, "
                          f"{streams} streams: {err} > {tol}")
        case = {"windows": n, "steps": steps, "real_tokens": 2 + streams, "max_abs_err": err,
                "tolerance": tol}
        if steps == 50 and streams == 3:
            flops = _sampler_flops(n, steps, 5, cfg.latent_dim, cfg.ff_size, cfg.num_layers)
            nbytes = weight_bytes + 4.0 * (steps * (cfg.latent_dim + 4) + n * 5 * cfg.latent_dim)
            # ms: the kernel launch alone; wrapper_ms adds the per-call
            # conditioning (time MLP, condition projections, coefficients)
            conditioning = precompute_conditioning(den, sched, con, emo, sty, steps)
            kernel = lambda: launch_sampler(packed, conditioning, x0, cfg)  # noqa: E731
            check(torch.equal(kernel(), out), "K3 launched alone differs from its wrapper")
            case.update(
                ms=cuda_ms(kernel, iters=5, warmup=1),
                wrapper_ms=cuda_ms(run, iters=5, warmup=1),
                plain_ms=cuda_ms(plain, iters=2, warmup=1),
                bound_ms=max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES
                else "bytes",
            )
        cases.append(case)
    emit({"phase": "sampler_k3", "cases": cases})
    return next(c for c in cases if c["windows"] == 1 and c["steps"] == 50)


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


def trace_wav_to_motion(pipe, chunks) -> None:
    """Device time by kernel for one wav_to_motion call (torch.profiler,
    CUPTI); the profiled call's host wall time includes the profiler's own
    overhead. The Chrome trace goes to chiprun_out/chip_smoke/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.wav_to_motion(chunks, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"kernel": e.key[:90], "ms": us / 1e3, "calls": e.count})
    rows.sort(key=lambda r: -r["ms"])
    prof.export_chrome_trace(str(OUT / "wav_to_motion_trace.json"))
    busy = sum(r["ms"] for r in rows)
    emit({"phase": "trace_wav_to_motion", "windows": chunks.shape[0], "wall_ms": wall_ms,
          "device_busy_ms": busy, "device_kernels": len(rows),
          "device_launches": sum(r["calls"] for r in rows), "top": rows[:12]})


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


def main() -> int:
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
    k1 = phase_attention()
    k3 = phase_sampler()
    phase_small_reference()
    launches = phase_main_path()
    phase_cli()
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
         "launches": launches["ddim_sampler"], "max_abs_err": k3["max_abs_err"],
         "tolerance": k3["tolerance"], "ms": k3["ms"], "wrapper_ms": k3["wrapper_ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
    ]
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
