"""The operation and byte counts against hand-worked values, and the
trace's arithmetic (busy time as a union, idle gaps named by the host)."""

from __future__ import annotations

import json

import pytest

from portbench import readers, roofline
from portbench.run import Context, Window
from portbench.tests.tiny import ROOT
from portbench.trace import Trace

CFG = json.loads((ROOT / "portbench" / "configs" / "amuse-infer.json").read_text())


def test_one_flagship_vit_pass():
    # 1214 tokens (12 x 101 patches + 2), 768 wide, 12 blocks, MLP 3072:
    # 1214*12*2*(4*768^2 + 2*768*3072) + 12*4*1214^2*768 + 1212*2*256*768 + 2*768*256
    hand = 206_221_344_768 + 54_330_015_744 + 476_577_792 + 393_216
    assert roofline.vit_forward_flops(CFG["ast"]) == hand
    assert roofline.vit_forward_flops(CFG["ast"]) == pytest.approx(2.61e11, rel=2e-3)


def test_sampler_counts_match_the_bound_chip_smoke_used():
    # 50 steps over 5 tokens of the 9-layer denoiser at N = 1: 9.56e8 FLOP,
    # 0.0143 ms at 67 TFLOP/s (ROADMAP's K3 bound)
    flops = roofline.sampler_flops(CFG["denoiser"], 1, 50)
    per_layer = 2 * 5 * (4 * 128 * 128 + 2 * 128 * 512) + 4 * 25 * 128
    assert flops == 50 * (9 * per_layer + 4 * 2 * 5 * 2 * 128 * 128)
    assert flops / roofline.PEAK_F32_FLOPS * 1e3 == pytest.approx(0.0143, rel=0.01)


def test_attention_and_roofline_share():
    # K1 at the AST's (3, 12, 1214, 64) bf16: 1.357e10 FLOP, 4 x 5.59 MB
    flops = roofline.attention_fwd_flops(3, 12, 1214, 64)
    nbytes = roofline.attention_fwd_bytes(3, 12, 1214, 64, "bfloat16")
    assert flops == 4 * 3 * 12 * 1214 ** 2 * 64 and nbytes == 4 * 3 * 12 * 1214 * 64 * 2
    bound = flops / 989e12  # operations bound it
    assert roofline.roofline_pct(flops, nbytes, 2 * bound, "bfloat16") == pytest.approx(50.0)
    assert roofline.roofline_pct(1.0, 3.35e12, 2.0, "float32") == pytest.approx(50.0)


def test_window_flops_sum_their_parts():
    parts = (3 * roofline.vit_forward_flops(CFG["ast"])
             + roofline.sampler_flops(CFG["denoiser"], 1, 50)
             + roofline.decode_flops(CFG["prior"]))
    assert roofline.infer_window_flops(CFG) == parts
    assert 7.8e11 < parts < 8.0e11


def _trace():
    t = Trace(start=0.0, end=1.0)
    # two overlapping kernels and one copy; the sum would read 0.9 s
    t.device = [("(anonymous namespace)::attn_fwd_wgmma_kernel<64>", 0.1, 0.4),
                ("gemm", 0.3, 0.5), ("Memcpy DtoH", 0.7, 0.8), ("before", -0.5, -0.1)]
    t.host = [("aten::linear", 0.05, 0.09, "cpu_op"), ("cudaMemcpyAsync", 0.5, 0.7, ""),
              ("cudaStreamSynchronize", 0.55, 0.69, ""), ("aten::copy_", 0.79, 0.95, "")]
    return t


def test_busy_is_a_union_and_idle_is_named():
    t = _trace()
    assert t.busy_s == pytest.approx(0.5)  # [0.1, 0.5] and [0.7, 0.8]
    gaps = dict(t.idle_gaps())
    assert gaps["before aten::linear"] == pytest.approx(0.1)  # [0, 0.1]: host not yet in an op
    assert gaps["cudaMemcpyAsync"] == pytest.approx(0.2)  # [0.5, 0.7]
    assert gaps["aten::copy_"] == pytest.approx(0.2)  # [0.8, 1.0]
    assert sum(gaps.values()) == pytest.approx(1.0 - 0.5)
    assert t.kernel_records("attention_fwd") == 1
    assert t.kernel_seconds("attention_fwd") == pytest.approx(0.3)


def test_readers_on_a_trace():
    t = _trace()
    ctx = Context(CFG, 1.0, Window(0.0, 1.0, []), trace=t, counted={"attention_fwd": 1},
                  slice_work={"attention_fwd": (989e12 * 0.15, 0.0)}, slice_untraced_s=0.8)
    # idle over the same work untraced (0.8 s), not over the traced slice (1 s)
    assert readers.device_idle_pct(ctx) == pytest.approx(100.0 * 0.3 / 0.8)
    assert readers.kernel_roofline_pct(ctx, "attention_fwd", "bfloat16") == pytest.approx(50.0)
    assert readers.kernel_roofline_pct(ctx, "ddim_sampler", "float32") is None
    assert readers.device_idle_pct(Context(CFG, 1.0, Window(0.0, 1.0, []))) is None
