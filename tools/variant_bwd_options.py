"""Register options of the bf16 attention-variant backward, timed on the card.

Builds ``amuse_tpu_torch/csrc/attention_variants_bwd.cu`` as it is and with
each edit of ``OPTIONS`` (and, with ``--parent DIR``, the same source of a
parent checkout), one nvcc each in parallel, then for every build prints
one JSON line a row:

  * ptxas's registers and spills of each wgmma kernel;
  * the largest error of the v1, v0 and v4 backwards over
    ``kernel_variants.kernel_limit`` at (4, 12, 1214, 64) bf16 and on the
    cancellation cases, and whether a rerun is bit-equal;
  * per turn (builds in order, then in reverse: A, B, B, A for two), the ms
    of each body at (4, 12, 1214, 64) bf16 on CUDA events (20 calls after
    10) and each kernel's device ms from torch.profiler (5 calls).

    python tools/variant_bwd_options.py [--parent DIR] [--turns 2]

It needs a CUDA card and nvcc; the builds go to build/variant_bwd_options/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "amuse_tpu_torch" / "csrc" / "attention_variants_bwd.cu"
OUT = ROOT / "build" / "variant_bwd_options"
SHAPE = (4, 12, 1214, 64)
BODIES = ("v1", "v0", "v4")
# one k-step group of split pieces in flight at a time, not two
ONE_GROUP = ("    wgmma_commit();\n    wgmma_wait<1>();\n  }\n}",
             "    wgmma_commit();\n    wgmma_wait<0>();\n  }\n}")
# V1 and V0 columns blocks of three warpgroups, as V4's (168 registers a thread)
THREE_WGS = ("return body == V4 ? 3 : 2;", "return 3;")
# the kernels' argument struct without __grid_constant__ (every kernel)
PLAIN_PARAM = ("(const __grid_constant__ WArgs a)", "(const WArgs a)")
OPTIONS = {"kept": (), "one_group": (ONE_GROUP,), "three_warpgroups": (THREE_WGS,),
           "three_warpgroups_one_group": (THREE_WGS, ONE_GROUP), "plain_param": (PLAIN_PARAM,)}


def build(sources: dict) -> dict:
    """{name: source text} -> {name: (library, {kernel: ptxas line})}."""
    from amuse_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = SRC.with_name(f"_options_{name}.cu")  # beside sm90_tile.cuh
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), cu)
    built = {}
    for name, (proc, cu) in procs.items():
        log, _ = proc.communicate()
        cu.unlink()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on option {name}:\n{log}")
        ptxas, kernel = {}, "?"
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '_Z\w*?_cu_[0-9a-f]{8}\d+(\w+?_wgmma)", ln)
            if "Compiling entry function" in ln:
                kernel = m.group(1) if m else "?"
            elif kernel != "?" and ("registers" in ln or "spill" in ln):
                ptxas[kernel] = (ptxas.get(kernel, "") + " " + ln.split(":", 1)[-1].strip()).strip()
        built[name] = (ctypes.CDLL(str(OUT / f"lib{name}.so")), ptxas)
    return built


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a parent checkout's root: its source is built too")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("variant_bwd_options needs a CUDA card")
    from amuse_tpu_torch.ops import kernel_variants as kv

    text = SRC.read_text()
    sources = {}
    for name, edits in OPTIONS.items():
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"option {name}: the source no longer holds {old!r}")
            t = t.replace(old, new)
        sources[name] = t
    if args.parent:
        sources["parent"] = (Path(args.parent) / SRC.relative_to(ROOT)).read_text()
    built = build(sources)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)

    def run(lib, q, k, v, do, body):
        """One variant_bwd of ``lib`` -> (dq, dk, dv); the parent's entry point
        may lack the route argument."""
        b, h, s, _ = q.shape
        outs = [torch.empty_like(q) for _ in range(3)]
        stats = torch.empty((b * h, 3, -(-s // 64) * 64), dtype=torch.float32, device=q.device)
        route = ctypes.c_int(-1)
        lib.variant_bwd.restype = ctypes.c_int
        rc = lib.variant_bwd(*(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, do, stats, *outs)),
                             1, kv.BWD_BODIES[body], b, h, s, ctypes.c_float(kv.SCALE),
                             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
                             ctypes.byref(route))
        if rc:
            raise RuntimeError(f"variant_bwd returned CUDA error {rc}")
        return outs

    g = torch.Generator(device="cuda").manual_seed(12)
    x = [(torch.randn(SHAPE, generator=g, device="cuda") * (0.5 if i < 3 else 1.0))
         .to(torch.bfloat16) for i in range(4)]
    cases = {"harness": x, **{f"{body}:{c}": [t.cuda() for t in kv.cancellation_inputs(c)]
                              for body, names in kv.CANCELLATION_CASES.items() for c in names}}
    for name, (lib, ptxas) in built.items():
        worst, equal = {}, True
        for case, (q, k, v, do) in cases.items():
            for body in BODIES if case == "harness" else (case.split(":")[0],):
                got, again = run(lib, q, k, v, do, body), run(lib, q, k, v, do, body)
                for gr, ref, rerun in zip(got, kv.variant_bwd_reference(q, k, v, do, body), again):
                    ref = ref.float()
                    lim = kv.kernel_limit(q.dtype, body, ref.abs().max().item())
                    err = (gr.float() - ref).abs().max().item() / lim
                    worst[f"{body} {case}"] = max(worst.get(f"{body} {case}", 0.0), err)
                    equal &= bool(torch.equal(gr, rerun))
        print(json.dumps({"option": name, "ptxas": ptxas, "err_over_limit": worst,
                          "reruns_bit_equal": equal}), flush=True)

    q, k, v, do = x
    order = list(built)
    for turn in range(args.turns):
        for name in order if turn % 2 == 0 else order[::-1]:
            lib = built[name][0]
            row = {"turn": turn, "option": name}
            for body in BODIES:
                def fn():
                    return run(lib, q, k, v, do, body)
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                kernels = {m.group(1): e.device_time_total / 1e3 / 5 for e in prof.key_averages()
                           if (m := re.search(r"::(\w+_(?:wgmma|f32))\b", e.key))}
                row[body] = {"ms": start.elapsed_time(end) / 20, "kernels_ms": kernels,
                             "device_ms": sum(kernels.values())}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
