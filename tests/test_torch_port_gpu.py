"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
only torch and the port, so it runs where JAX is absent; the repository's
conftest.py imports JAX, so on the GPU machine run it with

    python -m pytest tests/test_torch_port_gpu.py --noconftest -m gpu -q
"""

import dataclasses
import os
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the H100)")
    from amuse_tpu_torch.device import resolve_device

    # the CPU references: a process's first parallel float32 sqrt on the CPU can
    # compute one worker's share imprecisely (seen with torch 2.13.0+cpu: one
    # eighth of it off by up to 2.4e-4 relative), so one runs before them
    torch.ones(1 << 22).sqrt_()
    return resolve_device("cuda")


@pytest.mark.parametrize("dtype,shape,atol", [
    (torch.float32, (2, 2, 128, 64), 2e-5),
    (torch.float32, (1, 2, 70, 32), 2e-5),
    (torch.bfloat16, (1, 1, 128, 64), 3e-2),
    (torch.bfloat16, (2, 3, 257, 32), 3e-2),
])
def test_attention_kernel_matches_plain(cuda, dtype, shape, atol):
    from amuse_tpu_torch.ops.attention import mha, mha_reference

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    before = mha.launches
    out = mha(q, k, v)
    torch.cuda.synchronize()
    assert mha.launches == before + 1
    torch.testing.assert_close(out.float(), mha_reference(q, k, v).float(), atol=atol, rtol=0)


def test_attention_kernel_rejects_unsupported(cuda):
    from amuse_tpu_torch.ops.attention import mha

    q = torch.zeros((1, 1, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        mha(q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mha(q.half(), q.half(), q.half())


def test_attention_kernel_lse(cuda):
    """K1's optional row log-sum-exp equals torch.logsumexp of the scaled
    scores; the instantiation that writes it gives the same output, bit for
    bit, as the one without (the inference path's)."""
    from amuse_tpu_torch.ops.attention import _launch_fwd

    g = torch.Generator(device=cuda).manual_seed(2)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
        q, k, v = (torch.randn((2, 3, 70, 64), generator=g, device=cuda).to(dtype)
                   for _ in range(3))
        out, lse = _launch_fwd(q, k, v, with_lse=True)
        plain_out, none = _launch_fwd(q, k, v, with_lse=False)
        ref = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) / 8.0, dim=-1)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, ref, atol=atol, rtol=1e-5)
        assert none is None and torch.equal(out, plain_out)


# K2 tolerance: max |kernel - plain| <= rel * max |plain| per gradient.
# float32: summation order and Delta = rowsum(dO * O) against rowsum(dP * P).
# bfloat16: one or two bf16 ulps of the outputs, and dS rounded to bf16 from
# slightly different float32 values.
K2_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (1, 2, 70, 32)),
    (torch.float32, (2, 2, 70, 64)),
    (torch.bfloat16, (1, 2, 70, 32)),
    (torch.bfloat16, (2, 3, 257, 64)),
])
def test_attention_bwd_kernel_matches_plain(cuda, dtype, shape):
    """K2 through mha_train's backward, on strided views of a fused qkv
    tensor as the ViT block feeds it, against mha_bwd_reference and against
    autograd through mha_reference."""
    from amuse_tpu_torch.ops.attention import (mha, mha_bwd, mha_bwd_reference, mha_reference,
                                               mha_train)

    b, h, s, d = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device=cuda).to(dtype).requires_grad_()
    do = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    k1, k2 = mha.launches, mha_bwd.launches
    out = mha_train(qkv)
    out.backward(do)
    torch.cuda.synchronize()
    assert (mha.launches, mha_bwd.launches) == (k1 + 1, k2 + 1)
    q, k, v = (qkv.detach()[:, :, i].transpose(1, 2) for i in range(3))
    torch.testing.assert_close(out.float(), mha_reference(q, k, v).float(),
                               atol=3e-2 if dtype == torch.bfloat16 else 2e-5, rtol=0)
    plain = mha_bwd_reference(q, k, v, do)
    qkv_ref = qkv.detach().clone().requires_grad_()
    mha_reference(*(qkv_ref[:, :, i].transpose(1, 2) for i in range(3))).backward(do)
    auto = [qkv_ref.grad[:, :, i].transpose(1, 2) for i in range(3)]
    for i in range(3):
        got = qkv.grad[:, :, i].transpose(1, 2).float()
        for ref in (plain[i].float(), auto[i].float()):
            err = (got - ref).abs().max().item()
            assert err <= K2_REL[dtype] * ref.abs().max().item(), (i, err)


# sequence lengths at the edges of the kernels' 64-, 128- and 192-row tiles,
# the AST length and its multiple of 128
SWEEP = [1, 63, 64, 65, 127, 128, 129, 257, 1214, 1280]


def _fused_qkv(cuda, dtype, s, d, seed, offset=0):
    """(1, S, 3, 2, D) fused projection as a view at ``offset`` elements into
    its storage, and dO (1, 2, S, D)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    flat = torch.randn(offset + s * 3 * 2 * d, generator=g, device=cuda).to(dtype)
    qkv = flat[offset:].view(1, s, 3, 2, d)
    return qkv, torch.randn((1, 2, s, d), generator=g, device=cuda).to(dtype)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_sweep(cuda, dtype, s, d):
    """K1 with and without the row log-sum-exp, on strided views of a fused
    qkv tensor, against its plain version (largest error, and the relative L2
    error, which a long sequence's small outputs do not hide) and
    torch.logsumexp; the two instantiations give the same output bit for bit."""
    from amuse_tpu_torch.ops.attention import _launch_fwd, mha, mha_reference

    qkv, _ = _fused_qkv(cuda, dtype, s, d, seed=s + d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = mha(q, k, v)
    out_lse, lse = _launch_fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    plain = mha_reference(q, k, v).float()
    torch.testing.assert_close(out.float(), plain, atol=3e-2 if bf16 else 2e-5, rtol=0)
    assert ((out.float() - plain).norm() / plain.norm()).item() <= (6e-3 if bf16 else 1e-5)
    ref = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) / d ** 0.5, dim=-1)
    torch.testing.assert_close(lse, ref, atol=1e-4 if bf16 else 1e-5, rtol=1e-5)
    assert torch.equal(out, out_lse)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_sweep(cuda, dtype, s, d):
    """K2 against its plain version over the tile-edge lengths, K2_REL of
    each gradient's largest entry plus 1e-5: at S = 1 dq and dk are exactly 0
    in the plain version (dP - rowsum(dP * P) cancels) and rounding noise of
    dP - Delta in the kernel. Two launches on the same inputs are bit-equal
    (no atomics)."""
    from amuse_tpu_torch.ops.attention import _launch_fwd, mha_bwd, mha_bwd_reference

    qkv, do = _fused_qkv(cuda, dtype, s, d, seed=2 * s + d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out, lse = _launch_fwd(q, k, v, with_lse=True)
    got, again = mha_bwd(q, k, v, out, do, lse), mha_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert got.shape == (1, s, 3, 2, d) and got.is_contiguous() and torch.equal(got, again)
    for i, ref in enumerate(mha_bwd_reference(q, k, v, do)):
        err = (got[:, :, i].transpose(1, 2).float() - ref.float()).abs().max().item()
        assert err <= K2_REL[dtype] * ref.float().abs().max().item() + 1e-5, ("qkv"[i], err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_take_many_heads(cuda, dtype):
    """Every grid is one dimension of (batch*head, row tile) pairs: B * H
    above 65535, a grid's second dimension, runs through K1 and K2. Outputs
    of a 3-key softmax reach |v| ~ 4, where two bf16 ulps are 0.031: the bf16
    output gets torch.testing's relative 1.6e-2 beside the absolute 3e-2."""
    from amuse_tpu_torch.ops.attention import mha_bwd_reference, mha_reference, mha_train

    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((35000, 3, 3, 2, 32), generator=g, device=cuda).to(dtype)
    do = torch.randn((35000, 2, 3, 32), generator=g, device=cuda).to(dtype)
    leaf = qkv.clone().requires_grad_()
    out = mha_train(leaf)
    (grad,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), mha_reference(q, k, v).float(),
                               atol=3e-2 if bf16 else 2e-5, rtol=1.6e-2 if bf16 else 0)
    for i, ref in enumerate(mha_bwd_reference(q, k, v, do)):
        err = (grad[:, :, i].transpose(1, 2).float() - ref.float()).abs().max().item()
        assert err <= K2_REL[dtype] * ref.float().abs().max().item(), ("qkv"[i], err)


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 8), (torch.bfloat16, 4096),
                                          (torch.float32, 3)])
def test_attention_kernels_take_offset_views(cuda, dtype, offset):
    """q, k, v as strided views that start inside their storage (bf16: at a
    16-byte boundary; float32: anywhere), through mha_train and its backward."""
    from amuse_tpu_torch.ops.attention import mha_bwd_reference, mha_reference, mha_train

    qkv, do = _fused_qkv(cuda, dtype, 200, 64, seed=5, offset=offset)
    assert qkv.storage_offset() == offset
    leaf = qkv.detach().requires_grad_()
    out = mha_train(leaf)
    (grad,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    torch.testing.assert_close(out.float(), mha_reference(q, k, v).float(),
                               atol=3e-2 if dtype == torch.bfloat16 else 2e-5, rtol=0)
    for i, ref in enumerate(mha_bwd_reference(q, k, v, do)):
        err = (grad[:, :, i].transpose(1, 2).float() - ref.float()).abs().max().item()
        assert err <= K2_REL[dtype] * ref.float().abs().max().item(), ("qkv"[i], err)


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    """A misaligned bf16 view, a head dim the kernels lack, another type, a
    missing or misshapen log-sum-exp: the wrappers raise, nothing falls back."""
    from amuse_tpu_torch.ops.attention import _launch_fwd, mha, mha_bwd, mha_train

    qkv, do = _fused_qkv(cuda, torch.bfloat16, 70, 64, seed=6, offset=1)  # 2 bytes in
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        mha(q, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mha_train(qkv)
    with pytest.raises(ValueError, match="head dim"):
        mha_train(torch.zeros((1, 8, 3, 2, 48), device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mha_train(torch.zeros((1, 8, 3, 2, 64), device=cuda, dtype=torch.float16))
    qkv, do = _fused_qkv(cuda, torch.bfloat16, 70, 64, seed=6)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out, lse = _launch_fwd(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        mha_bwd(q, k, v, out, do, None)
    with pytest.raises(ValueError, match="lse"):
        mha_bwd(q, k, v, out, do, lse[:, :, :-1])
    with pytest.raises(ValueError, match="o and do"):
        mha_bwd(q, k, v, out[:, :, :-1], do, lse)


def test_attention_forward_refuses_grad_on_cuda(cuda):
    """mha on CUDA would return a tensor with no grad_fn: it refuses inputs
    that need a gradient and points to mha_train."""
    from amuse_tpu_torch.ops.attention import mha

    q = torch.zeros((1, 1, 8, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="mha_train"):
        mha(q, q, q)
    with torch.no_grad():
        assert mha(q, q, q).shape == q.shape


@pytest.mark.parametrize("dtype,remat", [(torch.float32, False), (torch.bfloat16, False),
                                         (torch.bfloat16, True)])
def test_train_step_launch_counts(cuda, dtype, remat):
    """One stage-1 train step at small width launches K1 and K2 once per ViT
    block (the three encoders stacked); remat replays each block's forward,
    so K1 runs twice per block."""
    import numpy as np

    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.ops.attention import mha, mha_bwd
    from amuse_tpu_torch.train import audio as ta

    ast_cfg = ASTConfig(input_tdim=64, input_fdim=32, embed_dim=64, depth=2, num_heads=2,
                        feature_dim=16, remat=remat)
    cfg = ta.AudioTrainConfig(freq_mask=4, time_mask=8)
    state = ta.init_state(0, cfg, dtype, ast_cfg, cuda)
    step, _ = ta.make_train_step(cfg)
    rng = np.random.default_rng(0)
    batch = ta.batch_to_device({"fbanks": rng.normal(size=(2, 4, 64, 32)).astype(np.float32),
                                "emo_id": [1, 2], "a1_id": [3, 4], "a2_id": [5, 6]}, cuda)
    before = (mha.launches, mha_bwd.launches)
    logs = step(state, batch, ta.step_generator(0, 0, 0, cuda))
    torch.cuda.synchronize()
    k1 = ast_cfg.depth * (2 if remat else 1)
    assert (mha.launches - before[0], mha_bwd.launches - before[1]) == (k1, ast_cfg.depth)
    assert torch.isfinite(logs["total"]) and state.step == 1


@pytest.mark.parametrize("streams", [3, 1])
def test_sampler_kernel_matches_plain(cuda, streams):
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from amuse_tpu_torch.ops.denoiser_kernel import ddim_sample_fused, ddim_sample_reference

    torch.manual_seed(0)
    den = Denoiser(DenoiserConfig()).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    con, emo, sty = (torch.randn((2, 256), generator=g, device=cuda) for _ in range(3))
    if streams == 1:
        emo = sty = None
    x0 = torch.randn((2, 1, 128), generator=g, device=cuda)
    sched = make_schedule()
    before = ddim_sample_fused.launches
    out = ddim_sample_fused(den, sched, con, emo, sty, 10, initial_latents=x0)
    ref = ddim_sample_reference(den, sched, con, emo, sty, x0, 10)
    torch.cuda.synchronize()
    assert ddim_sample_fused.launches == before + 1
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=1e-2)


# the sampler's widths: flagship (d 128, ff 512, 9 layers, 4 heads), the
# small widths chip_smoke runs, d 64 over 5 layers, the widest of the
# reference's prior sweep (amuse_tpu/cluster/sweep.py: d 256, ff 1024) and
# d 512 / ff 2048, and head dim 1 (the scores of 32 heads in several passes)
SAMPLER_DIMS = {
    "flagship": {},
    "d32": {"latent_dim": 32, "ff_size": 64, "num_layers": 3, "num_heads": 2, "cond_dim": 24},
    "d64": {"latent_dim": 64, "ff_size": 128, "num_layers": 5, "num_heads": 4, "cond_dim": 24},
    "d256": {"latent_dim": 256, "ff_size": 1024, "num_layers": 9, "num_heads": 8},
    "d512": {"latent_dim": 512, "ff_size": 2048, "num_layers": 9, "num_heads": 8},
    "hd1": {"latent_dim": 32, "ff_size": 64, "num_layers": 3, "num_heads": 32, "cond_dim": 24},
}
# 50 steps at the flagship dims: 4.6 times the largest reading on an H100
# (chip_smoke.K3_TOL); other widths: tests/test_denoiser_kernel.py:47
SAMPLER_ATOL_50 = {"flagship": 2e-4}
_DENOISERS = {}


def _sampler_denoiser(cuda, dims):
    from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig

    if dims not in _DENOISERS:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(len(dims))
            _DENOISERS[dims] = Denoiser(DenoiserConfig(**SAMPLER_DIMS[dims])).to(cuda).eval()
    return _DENOISERS[dims]


def _sampler_inputs(cuda, den, n, tokens, seed):
    """(con, emo, sty) for ``tokens`` real tokens (None streams dropped) and x0."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    a, b, c = (torch.randn((n, den.cfg.cond_dim), generator=g, device=cuda) for _ in range(3))
    streams = {2: (None, None, None), 3: (a, None, None), 4: (a, None, c), 5: (a, b, c)}[tokens]
    return streams, torch.randn((n, 1, den.cfg.latent_dim), generator=g, device=cuda)


@pytest.mark.parametrize("steps,atol", [(1, 2e-4), (50, 2e-3)])
@pytest.mark.parametrize("n", [1, 3, 8, 40])
@pytest.mark.parametrize("tokens", [2, 3, 5])
@pytest.mark.parametrize("dims", list(SAMPLER_DIMS))
def test_sampler_cluster_kernel_sweep(cuda, dims, tokens, n, steps, atol):
    """The cluster kernel against ddim_sample_reference: 2 real tokens
    (latent and time alone, launched directly), 3 and 5; N windows up to
    more clusters of 8 than the card runs at once; one step (atol 2e-4) and 50
    (2e-3, the bounds of tests/test_denoiser_kernel.py; 2e-4 at the
    flagship dims)."""
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    if steps == 50:
        atol = SAMPLER_ATOL_50.get(dims, atol)
    den = _sampler_denoiser(cuda, dims)
    (con, emo, sty), x0 = _sampler_inputs(cuda, den, n, tokens, seed=100 * n + tokens)
    sched = make_schedule()
    pack = dk.pack_for_cluster(dk.pack_denoiser(den), dk.cluster_for(den.cfg, n))
    sched_cond = dk.schedule_conditioning(den, sched, steps)
    cond = (dk.condition_tokens(den, con, emo, sty) if con is not None
            else torch.empty((n, 0, den.cfg.latent_dim), device=cuda))
    before = dk.ddim_sample_fused.launches
    out = dk.launch_sampler(pack, sched_cond, cond, x0, den.cfg)
    ref = dk.ddim_sample_reference(den, sched, con, emo, sty, x0, steps)
    torch.cuda.synchronize()
    assert dk.ddim_sample_fused.launches == before + 1 and out.shape == (n, 1, den.cfg.latent_dim)
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dims", list(SAMPLER_DIMS))
def test_sampler_kernel_bit_equal_reruns(cuda, dims):
    """Two launches on the same inputs are bit-equal (FF2's partial sums are
    added in rank order, no atomics), and ddim_sample_fused, with and without
    the precomputed pack and schedule part, returns the launch's latents."""
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    den = _sampler_denoiser(cuda, dims)
    (con, emo, sty), x0 = _sampler_inputs(cuda, den, 3, 5, seed=7)
    sched = make_schedule()
    weights = dk.SamplerWeights(dk.pack_denoiser(den))
    pack = weights.for_cluster(dk.cluster_for(den.cfg, 3))
    sched_cond = dk.schedule_conditioning(den, sched, 50)
    cond = dk.condition_tokens(den, con, emo, sty)
    first = dk.launch_sampler(pack, sched_cond, cond, x0, den.cfg)
    second = dk.launch_sampler(pack, sched_cond, cond, x0, den.cfg)
    given = dk.ddim_sample_fused(den, sched, con, emo, sty, 50, initial_latents=x0,
                                 packed=weights, conditioning=sched_cond)
    built = dk.ddim_sample_fused(den, sched, con, emo, sty, 50, initial_latents=x0)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, given) and torch.equal(first, built)


def test_sampler_kernel_refuses_what_it_does_not_take(cuda):
    """Six real tokens, an even layer count, a width that is not a multiple
    of 4 and a schedule part of another step count raise before any launch."""
    import dataclasses

    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    sched = make_schedule()
    den = _sampler_denoiser(cuda, "d32")
    (con, emo, sty), x0 = _sampler_inputs(cuda, den, 2, 5, seed=3)
    weights = dk.SamplerWeights(dk.pack_denoiser(den))
    pack = weights.for_cluster(dk.cluster_for(den.cfg, 2))
    sched_cond = dk.schedule_conditioning(den, sched, 4)
    before = dk.ddim_sample_fused.launches
    cond = torch.zeros((2, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="at most 5 tokens"):
        dk.launch_sampler(pack, sched_cond, cond, x0, den.cfg)
    with pytest.raises(ValueError, match="steps"):
        dk.ddim_sample_fused(den, sched, con, emo, sty, 5, initial_latents=x0, packed=weights,
                             conditioning=sched_cond)
    with pytest.raises(ValueError, match="odd layers"):  # no Denoiser has an even count
        dk.launch_sampler(pack, sched_cond, cond[:, :3], x0,
                          dataclasses.replace(den.cfg, num_layers=4))
    cfg = {**SAMPLER_DIMS["d32"], "latent_dim": 30}
    other = Denoiser(DenoiserConfig(**cfg)).to(cuda).eval()
    with pytest.raises(ValueError, match="multiples of 4"):
        dk.ddim_sample_fused(other, sched, con, emo, sty, 4,
                             initial_latents=torch.zeros((2, 1, 30), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):  # d 2048: 200 KB of activations
        dk.cluster_for(dataclasses.replace(den.cfg, latent_dim=2048, ff_size=2048,
                                           num_layers=1, num_heads=8), 1)
    assert dk.ddim_sample_fused.launches == before


# Past the sweep's widths: the largest d the one-block kernel this one
# replaced took (one layer), and an edge of its shared memory (d 460, ff
# 2048, 21 layers), where only a cluster of one fits, products do not
# split K, and segments are larger than the weight ring.
EDGE_DIMS = {
    "d1164": {"latent_dim": 1164, "ff_size": 2048, "num_layers": 1, "num_heads": 4},
    "d460_l21": {"latent_dim": 460, "ff_size": 2048, "num_layers": 21, "num_heads": 4},
}
SAMPLER_DIMS.update(EDGE_DIMS)


@pytest.mark.parametrize("dims", ["flagship", "d256", "d512", *EDGE_DIMS])
def test_sampler_kernel_at_every_cluster_size(cuda, dims):
    """At every cluster size whose plan takes the dims (the wrapper picks
    one of them by the window count), 50 steps agree with the plain loop
    (atol 2e-3; 2e-4 at the flagship dims) and two launches are bit-equal."""
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    den = _sampler_denoiser(cuda, dims)
    cfg = den.cfg
    (con, emo, sty), x0 = _sampler_inputs(cuda, den, 2, 5, seed=11)
    sched = make_schedule()
    sched_cond = dk.schedule_conditioning(den, sched, 50)
    cond = dk.condition_tokens(den, con, emo, sty)
    ref = dk.ddim_sample_reference(den, sched, con, emo, sty, x0, 50)
    packed, ran = dk.pack_denoiser(den), []
    for c in dk.CLUSTER_SIZES:
        if dk._plan(cfg.latent_dim, cfg.ff_size, cfg.num_heads, cfg.num_layers, c)[0] is None:
            continue
        pack = dk.pack_for_cluster(packed, c)
        out = dk.launch_sampler(pack, sched_cond, cond, x0, cfg)
        again = dk.launch_sampler(pack, sched_cond, cond, x0, cfg)
        torch.cuda.synchronize()
        assert torch.equal(out, again), c
        torch.testing.assert_close(out, ref, atol=SAMPLER_ATOL_50.get(dims, 2e-3), rtol=0,
                                   msg=lambda m, c=c: f"cluster {c}: {m}")
        ran.append(c)
    assert ran


def _one_block_kernel_took(d, ff, layers):
    """The shapes the one-block sampler kernel took: d and ff multiples of 4
    up to 2048, and its shared memory (activations, hidden, skips, split-K
    scratch, latent) within 227 KB."""
    td = 5 * d
    floats = 6 * td + 5 * max(ff, 2 * d) + (layers - 1) // 2 * td + 512 * 4 * 5 + d
    return d % 4 == 0 and ff % 4 == 0 and max(d, ff) <= 2048 and 4 * floats <= 227 * 1024


def test_sampler_kernel_takes_every_shape_the_one_block_kernel_took(cuda):
    """Over a grid of widths and depths up to the edge of the one-block
    kernel's shared memory, every shape it took has a cluster size whose
    plan takes it and that the card runs."""
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    shapes = [(d, ff, layers) for d in (*range(4, 1200, 52), 128, 256, 460, 512, 1024, 1164)
              for ff in (4 * (d // 8 + 1), 2 * d, 4 * d, 1024, 2048)
              for layers in (1, 3, 9, 21, 41) if _one_block_kernel_took(d, ff, layers)]
    assert len(shapes) > 300 and (1164, 2048, 1) in shapes and (460, 2048, 21) in shapes
    for d, ff, layers in shapes:
        cfg = DenoiserConfig(latent_dim=d, ff_size=ff, num_layers=layers, num_heads=1)
        dk.sampler_plan(d, ff, 1, layers, dk.cluster_for(cfg, 1))


# ------------------------------------------------- edit and prepare_data paths
#
# Small widths with K1's head dim 32 (AST embed 64, 2 heads), float32: the
# card against the CPU plain path from the same weights. Features atol 1e-4;
# poses (as rotation matrices) and translation atol 1e-3, the bounds of the
# port against JAX on the CPU.
EDIT_FEAT_ATOL, EDIT_POSE_ATOL = 1e-4, 1e-3


def _small_cfgs():
    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig

    return (PriorConfig(latent_dim=32, ff_size=64, num_layers=3, num_heads=2),
            DenoiserConfig(latent_dim=32, ff_size=64, num_layers=3, num_heads=2, cond_dim=24),
            ASTConfig(embed_dim=64, depth=2, num_heads=2, feature_dim=24))


class _CpuNoise:
    """A pipeline whose initial DDIM latents and VAE noise come from a CPU
    generator seeded with the seed the editing code gave, so that the card
    and the CPU start from the same numbers."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    @staticmethod
    def _noise(generator, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(generator.initial_seed()))

    def generate_latents(self, con, emo=None, sty=None, generator=None, initial_latents=None):
        x0 = self._noise(generator, (con.shape[0], 1, self.pipe.denoiser_cfg.latent_dim))
        return self.pipe.generate_latents(con, emo, sty, initial_latents=x0)

    @torch.inference_mode()
    def encode_motion(self, feats, generator=None):
        noise = self._noise(generator, (feats.shape[0], 1, self.pipe.prior_cfg.latent_dim))
        return self.pipe.prior.encode(feats, noise=noise.to(self.pipe.device))[0]


@pytest.fixture(scope="module")
def edit_pipes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the H100)")
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params

    cfgs = _small_cfgs()
    params = init_random_params(5, *cfgs)
    return {dev: _CpuNoise(GesturePipeline(params, *cfgs, dtype=torch.float32,
                                           num_inference_steps=10, device=dev))
            for dev in ("cpu", "cuda")}


def _edit_inputs():
    import numpy as np

    rng = np.random.default_rng(6)
    out = []
    for i, windows in enumerate((2, 2, 3)):
        wave = rng.normal(scale=0.05, size=(1, windows * 160000 + 999)).astype(np.float32)
        t = windows * 300 + 4
        motion = np.concatenate([0.2 * rng.normal(size=(t, 165)), 0.1 * rng.normal(size=(t, 3))],
                                axis=1).astype(np.float32)
        out.append((("scott", "miranda", "scott")[i], ("0_9_9", "0_9_9", "0_65_65")[i], wave,
                    motion))
    return out


def _assert_motion_close(a, b):
    import numpy as np

    from amuse_tpu_torch.core.rotations import axis_angle_to_matrix

    np.testing.assert_allclose(a[1], b[1], atol=EDIT_POSE_ATOL, rtol=1e-3)
    np.testing.assert_allclose(axis_angle_to_matrix(torch.from_numpy(a[0])).numpy(),
                               axis_angle_to_matrix(torch.from_numpy(b[0])).numpy(),
                               atol=EDIT_POSE_ATOL, rtol=1e-3)


@pytest.mark.parametrize("task", ["emotion_control", "style_transfer", "style_xemo_transfer",
                                  "content_control", "demo_emotion_swap"])
def test_editing_on_the_card_matches_cpu(edit_pipes, task):
    """Each editing function on the card against the CPU plain path, with the
    launch counts of the card's run: K1 ``depth`` times per encode, K3 once
    per generated variant."""
    from amuse_tpu_torch.infer import editing
    from amuse_tpu_torch.ops import attention, denoiser_kernel

    outs, counts = {}, {}
    for dev, pipe in edit_pipes.items():
        attention.mha.launches = denoiser_kernel.ddim_sample_fused.launches = 0
        if task == "demo_emotion_swap":
            (_, _, a, _), (_, _, b, _), _ = _edit_inputs()
            out = editing.demo_emotion_swap(pipe, a, b, seed=2)
            encodes = 2
        else:
            lat = [editing.encode_take(pipe, actor, take, 0, wave, motion, seed=3)
                   for actor, take, wave, motion in _edit_inputs()]
            encodes = len(lat)
            out = {"emotion_control": lambda: editing.emotion_control(pipe, lat[::2], seed=2),
                   "style_transfer": lambda: editing.style_transfer(pipe, lat[:1], lat[1:2],
                                                                    seed=2),
                   "style_xemo_transfer": lambda: editing.style_xemo_transfer(
                       pipe, lat[0], lat[2], lat[1], dataclasses.replace(lat[1], take="0_65_65"),
                       seed=2),
                   "content_control": lambda: editing.content_control(pipe, lat[::2], seed=2),
                   }[task]()
            if dev == "cuda":
                for i, t in enumerate(lat):
                    cpu = outs["cpu_latents"][i]
                    for k in ("con", "emo", "sty", "z_motion"):
                        torch.testing.assert_close(getattr(t, k).cpu(), getattr(cpu, k),
                                                   atol=EDIT_FEAT_ATOL, rtol=1e-3)
            else:
                outs["cpu_latents"] = lat
        variants = sum(len(v) for v in out.values()) if task != "demo_emotion_swap" else 2
        counts[dev] = (attention.mha.launches, denoiser_kernel.ddim_sample_fused.launches)
        outs[dev] = out
    assert counts == {"cpu": (0, 0), "cuda": (encodes * 2, variants)}
    if task == "demo_emotion_swap":
        for k in ("original", "emotion_swapped"):
            _assert_motion_close(outs["cuda"][k], outs["cpu"][k])
        return
    assert outs["cuda"].keys() == outs["cpu"].keys()
    for source, variants_out in outs["cpu"].items():
        assert outs["cuda"][source].keys() == variants_out.keys()
        for variant, motion in variants_out.items():
            _assert_motion_close(outs["cuda"][source][variant], motion)


def test_released_dir_loads_on_the_card(cuda, tmp_path, monkeypatch):
    """A released directory (DataParallel AST, denoiser.-prefixed latdiff,
    decoys) loads into a pipeline on the card with every parameter bit-equal."""
    from amuse_tpu_torch.infer.pipeline import ENCODERS, GesturePipeline
    from amuse_tpu_torch.models.ast import ASTDisentangler
    from amuse_tpu_torch.models.denoiser import Denoiser
    from amuse_tpu_torch.models.vae import MotionPrior
    from amuse_tpu_torch.utils import checkpoint_io

    prior_cfg, den_cfg, ast_cfg = _small_cfgs()
    torch.manual_seed(0)
    sds = {"ast": ASTDisentangler(ast_cfg, fusion_dim=16).state_dict(),
           "prior": MotionPrior(prior_cfg).state_dict(), "denoiser": Denoiser(den_cfg).state_dict()}
    torch.save({f"module.{k}": v for k, v in sds["ast"].items()},
               tmp_path / "model_4_tL0.1_tEA0.9_tPA0.1_vL0.1_vEA0.1_vPA0.1.pkl")
    torch.save({"decoy": torch.zeros(1)},
               tmp_path / "model_2_tL0.1_tEA0.5_tPA0.9_vL0_vEA0_vPA0.pkl")
    torch.save(sds["prior"], tmp_path / "prior_model_NoOpt_total1.0000_e5.pt")
    torch.save({"decoy": torch.zeros(1)}, tmp_path / "prior_model_NoOpt_total0.1000_e6.pt")
    torch.save({"model_state_dict": {f"denoiser.{k}": v for k, v in sds["denoiser"].items()}},
               tmp_path / "latdiff_model_wOpt_total0.2000_e5.pt")
    torch.save({"decoy": torch.zeros(1)}, tmp_path / "latdiff_model_wOpt_total0.3000_e6.pt")
    monkeypatch.setenv("AMUSE_TPU_CKPT", str(tmp_path))
    pipe = GesturePipeline(checkpoint_io.load_pipeline_params(), prior_cfg, den_cfg, ast_cfg,
                           dtype=torch.float32, device=cuda)
    for kind, module in (("prior", pipe.prior), ("denoiser", pipe.denoiser)):
        for k, v in module.state_dict().items():
            assert v.is_cuda and torch.equal(v.cpu(), sds[kind][k]), (kind, k)
    for k, v in pipe.ast_params.items():
        assert torch.equal(v.cpu(), torch.stack([sds["ast"][f"{n}_enc.{k}"] for n in ENCODERS]))


def test_stage2_cache_on_the_card_matches_cpu(edit_pipes, tmp_path):
    """build_stage2_cache through encode_audio on the card and on the CPU:
    manifests equal, motion, audio and labels bit-equal, features within
    EDIT_FEAT_ATOL; 2 K1 launches (the AST depth) per take on the card."""
    import json

    import numpy as np

    from amuse_tpu_torch.audio.wavio import save_wav
    from amuse_tpu_torch.data import beat, cache
    from amuse_tpu_torch.ops import attention

    (tmp_path / "mosh").mkdir()
    for (actor, take, wave, motion), aid in zip(_edit_inputs(), (2, 9, 2)):
        (tmp_path / "beat" / str(aid)).mkdir(parents=True, exist_ok=True)
        save_wav(tmp_path / "beat" / str(aid) / f"{aid}_{actor}_{take}.wav", wave)
        np.savez(tmp_path / "mosh" / f"{aid}_{actor}_{take}.npz", poses=motion[:, :165],
                 trans=motion[:, 165:])
    subset = beat.stage2_subset(beat.discover(tmp_path / "beat", tmp_path / "mosh"))
    counts = {}
    for dev, pipe in edit_pipes.items():
        attention.mha.launches = 0
        cache.build_stage2_cache(
            subset, tmp_path / dev,
            lambda c, pipe=pipe: {k: v.cpu().numpy() for k, v in pipe.encode_audio(c).items()},
            progress=False)
        counts[dev] = attention.mha.launches
    assert counts == {"cpu": 0, "cuda": 2 * len(subset)} and len(subset) == 3
    manifest = json.loads((tmp_path / "cuda" / "manifest.json").read_text())
    assert manifest == json.loads((tmp_path / "cpu" / "manifest.json").read_text())
    assert manifest["num_windows"] == 7
    a, b = cache.WindowCache(tmp_path / "cuda"), cache.WindowCache(tmp_path / "cpu")
    for i in range(len(a)):
        for f in cache.FIELDS:
            if f in ("con", "emo", "sty"):
                np.testing.assert_allclose(a[i][f], b[i][f], atol=EDIT_FEAT_ATOL, rtol=1e-3)
            else:
                np.testing.assert_array_equal(a[i][f], b[i][f])


# ------------------------------------------------------- stage-2 (LPDM) training
#
# Small widths (prior and denoiser d 32, ff 64, 3 layers, 2 heads; 30-frame
# windows; the 50-step monitor; vertex monitors on a 64-vertex rig of the
# SMPL-X tree), float32, the step's draws made by a CPU generator.
LPDM_LOSS_RTOL, LPDM_GRAD_REL_L2 = 1e-3, 1e-3


def _lpdm(device, lr=1e-4, dropout=0.0):
    import dataclasses

    from amuse_tpu_torch.core import smplx
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig
    from amuse_tpu_torch.train import gesture as tg

    prior_cfg = PriorConfig(latent_dim=32, ff_size=64, num_layers=3, num_heads=2, window=30,
                            dropout=dropout)
    den_cfg = DenoiserConfig(latent_dim=32, ff_size=64, num_layers=3, num_heads=2,
                             cond_dim=24, dropout=dropout)
    tcfg = dataclasses.replace(tg.GestureTrainConfig(), learning_rate=lr)
    rig = smplx.make_test_model(num_vertices=64, num_joints=55, num_betas=300,
                                parents=smplx.SMPLX_PARENTS).to(device)
    return (tg.init_state(21, prior_cfg, den_cfg, tcfg, device),
            tg.make_train_step(prior_cfg, den_cfg, tcfg, rig), prior_cfg)


def _lpdm_batch(device, seed, b=4):
    import numpy as np

    from amuse_tpu_torch.train.gesture import batch_to_device

    rng = np.random.default_rng(seed)
    return batch_to_device({"motion": 0.2 * rng.normal(size=(b, 30, 168)),
                            **{k: rng.normal(size=(b, 24)) for k in ("con", "emo", "sty")},
                            "betas": 0.5 * rng.normal(size=(b, 300))}, device)


def _lpdm_noise(prior_cfg, device, seed, b=4):
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.train import gesture as tg

    noise = tg.draw_step_noise(torch.Generator().manual_seed(seed), b, prior_cfg,
                               make_schedule(), torch.device("cpu"))
    return tg.StepNoise(*(x.to(device) for x in noise))


def test_lpdm_step_on_the_card_matches_cpu(cuda):
    """Two steps (dropout off) on the card and on the CPU from the same
    weights, batch and draws: loss per step within LPDM_LOSS_RTOL, the
    gradients of step 1 within LPDM_GRAD_REL_L2 (relative L2, all together);
    one K3 launch per step on the card."""
    from amuse_tpu_torch.ops.denoiser_kernel import ddim_sample_fused

    out = {}
    for dev in ("cpu", cuda):
        state, step, prior_cfg = _lpdm(dev)
        batch = _lpdm_batch(dev, 3)
        before = ddim_sample_fused.launches
        losses, grads = [], None
        for i in range(2):
            losses.append(step(state, batch, stochastic=False,
                               noise=_lpdm_noise(prior_cfg, dev, 10 + i))["total"].item())
            if grads is None:
                grads = {n: p.grad.detach().cpu().clone()
                         for m in (state.prior, state.denoiser) for n, p in m.named_parameters()
                         if p.grad is not None}
        out[str(dev)] = (losses, grads, ddim_sample_fused.launches - before)
    (l_cpu, g_cpu, k_cpu), (l_gpu, g_gpu, k_gpu) = out["cpu"], out[str(cuda)]
    assert (k_cpu, k_gpu) == (0, 2)
    for a, c in zip(l_gpu, l_cpu):
        assert abs(a - c) <= LPDM_LOSS_RTOL * abs(c)
    assert g_gpu.keys() == g_cpu.keys()
    num = sum(((g_gpu[n] - g) ** 2).sum() for n, g in g_cpu.items())
    assert num.sqrt() <= LPDM_GRAD_REL_L2 * sum((g ** 2).sum() for g in g_cpu.values()).sqrt()


def test_lpdm_monitor_samples_with_the_updated_weights(cuda):
    """At lr 1e-2, a step's logged gen_feature is the plain loop's over the
    weights that step started from (the first step's update applied), far
    from the plain loop's over the weights before that update; K3 over the
    updated denoiser within 2e-3 of its plain loop (50 steps, small widths)."""
    import copy

    from amuse_tpu_torch.core.motion import featurize
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops import denoiser_kernel as dk
    from amuse_tpu_torch.train.losses import smooth_l1

    state, step, prior_cfg = _lpdm(cuda, lr=1e-2)
    batch, sched = _lpdm_batch(cuda, 4), make_schedule()
    conds = (batch["con"], batch["emo"], batch["sty"])
    before = (copy.deepcopy(state.prior), copy.deepcopy(state.denoiser))
    step(state, batch, stochastic=False, noise=_lpdm_noise(prior_cfg, cuda, 20))
    updated = (copy.deepcopy(state.prior), copy.deepcopy(state.denoiser))
    noise = _lpdm_noise(prior_cfg, cuda, 21)
    logged = step(state, batch, stochastic=False, noise=noise)["gen_feature"].item()

    @torch.no_grad()
    def gen_feature(prior, den):
        z = dk.ddim_sample_reference(den.eval(), sched, *conds, noise.latents, 50)
        return smooth_l1(prior.eval().decode(z), featurize(batch["motion"])).item()

    fresh, stale = gen_feature(*updated), gen_feature(*before)
    assert abs(logged - fresh) * 10 < abs(logged - stale), (logged, fresh, stale)
    den = state.denoiser.eval()
    out = dk.ddim_sample_fused(den, sched, *conds, 50, initial_latents=noise.latents)
    ref = dk.ddim_sample_reference(den, sched, *conds, noise.latents, 50)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=0)


def test_lpdm_prefetched_epoch_is_bit_equal(cuda):
    """Four stochastic steps (dropout 0.1) fed by prefetch_to_device equal,
    bit for bit, the same steps fed by copies on the default stream: the
    consumer's stream waits for the side stream's copy."""
    from amuse_tpu_torch.data.prefetch import prefetch_to_device
    from amuse_tpu_torch.train.audio import step_generator

    def host_batches():
        for i in range(4):
            yield {k: v.cpu().numpy() for k, v in _lpdm_batch("cpu", 30 + i).items()}

    runs = {}
    for name in ("prefetch", "default_stream"):
        state, step, _ = _lpdm(cuda, dropout=0.1)
        feed = (prefetch_to_device(host_batches(), 2, cuda) if name == "prefetch" else
                ({k: torch.as_tensor(v).to(cuda) for k, v in hb.items()}
                 for hb in host_batches()))
        logs = [{k: v.item() for k, v in step(state, b, step_generator(5, 0, i, cuda)).items()}
                for i, b in enumerate(feed)]
        runs[name] = (logs, [p.detach().clone() for m in (state.prior, state.denoiser)
                             for p in m.parameters()])
    (la, pa), (lb, pb) = runs["prefetch"], runs["default_stream"]
    assert len(la) == 4 and la == lb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


# ------------------------------------------- evaluation, embedder, native loader
#
# The eval at small widths (prior and denoiser d 32, 300-frame windows, 10
# DDIM steps) with the committed embedder and a 40-vertex rig of the SMPL-X
# tree, on the card and on the CPU: the same initial latents (a CPU
# generator per batch) and diversity pairs (a CPU generator), so every key
# of the report must agree.
EVAL_RTOL = 1e-3
EMB_LOSS_RTOL, EMB_GRAD_REL_L2 = 1e-5, 1e-5


def _eval_cache(n, cond_dim, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        audio = np.zeros(48000)  # silence and loud bursts: onsets far above threshold
        for s in range(500 + 37 * i, 48000 - 640, 5300):
            audio[s:s + 640] += 0.3 * rng.normal(size=640)
        items.append({"motion": (0.2 * rng.normal(size=(300, 168))).astype(np.float32),
                      **{k: rng.normal(size=cond_dim).astype(np.float32)
                         for k in ("con", "emo", "sty")},
                      "actor_id": np.int32(i % 5), "audio": audio.astype(np.float32)})
    return items


@pytest.mark.parametrize("space", ["rotation", "position"])
def test_eval_on_the_card_matches_cpu(cuda, space):
    """10 windows at batch 4 (K3 at N = 4, 4, 2): every numeric key of the
    report within EVAL_RTOL of the CPU's, the labels and R-precision counts
    equal; the audio beats found by the card's fbank equal the CPU's."""
    import numpy as np

    from amuse_tpu_torch.core import smplx
    from amuse_tpu_torch.eval import embedder as emb
    from amuse_tpu_torch.eval import runner
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.ops.denoiser_kernel import ddim_sample_fused

    prior_cfg, den_cfg, ast_cfg = _small_cfgs()
    params = init_random_params(7, prior_cfg, den_cfg, ast_cfg)
    cache = _eval_cache(10, den_cfg.cond_dim)
    rig = (smplx.make_test_model(num_vertices=40, num_joints=55, num_betas=10,
                                 parents=smplx.SMPLX_PARENTS) if space == "position" else None)
    reports = {}
    for dev in ("cpu", "cuda"):
        pipe = GesturePipeline(params, prior_cfg, den_cfg, ast_cfg, dtype=torch.float32,
                               num_inference_steps=10, device=dev)
        before = ddim_sample_fused.launches
        reports[dev] = runner.evaluate_cache(pipe, cache, batch_size=4, seed=3,
                                             smplx_model=None if rig is None else rig.to(dev),
                                             embedder=emb.load(emb.DEFAULT_WEIGHTS))
        assert ddim_sample_fused.launches - before == (3 if dev == "cuda" else 0)
    cpu, gpu = reports["cpu"], reports["cuda"]
    assert gpu.keys() == cpu.keys() and gpu["metric_space"] == space
    for k, v in cpu.items():
        if isinstance(v, str) or k.startswith("r_precision_top"):
            assert gpu[k] == v, k
        else:
            assert gpu[k] == pytest.approx(v, rel=EVAL_RTOL, abs=1e-6), k
    waves = np.stack([it["audio"] for it in cache])
    for a, b in zip(runner.audio_beats(waves, cuda), runner.audio_beats(waves, "cpu")):
        assert a.size >= 4 and np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 7])
def test_sampler_tail_batches_match_plain(cuda, n):
    """K3 at the eval's tail sizes (N = n_windows mod 32), flagship dims, 50
    steps, as the pipeline launches it (its packed weights and schedule
    conditioning): within 2e-4 of the plain loop (chip_smoke.K3_TOL)."""
    from amuse_tpu_torch.diffusion.schedulers import make_schedule
    from amuse_tpu_torch.ops import denoiser_kernel as dk

    den, sched = _sampler_denoiser(cuda, "flagship"), make_schedule()
    (con, emo, sty), x0 = _sampler_inputs(cuda, den, n, 5, seed=700 + n)
    weights = dk.SamplerWeights(dk.pack_denoiser(den))
    sched_cond = dk.schedule_conditioning(den, sched, 50)
    before = dk.ddim_sample_fused.launches
    out = dk.ddim_sample_fused(den, sched, con, emo, sty, 50, initial_latents=x0,
                               packed=weights, conditioning=sched_cond)
    ref = dk.ddim_sample_reference(den, sched, con, emo, sty, x0, 50)
    torch.cuda.synchronize()
    assert dk.ddim_sample_fused.launches == before + 1
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)


def test_embedder_step_on_the_card_matches_cpu(cuda):
    """The committed embedder's widths (in 333, T 300, channels 128/64,
    latent 64), batch 4: forward, reconstruction loss and gradients on the
    card against the CPU (loss EMB_LOSS_RTOL, gradients EMB_GRAD_REL_L2,
    relative L2 over all of them); the embedding within 1e-5."""
    import numpy as np

    from amuse_tpu_torch.eval import embedder as emb

    params, cfg, _ = emb.load(emb.DEFAULT_WEIGHTS)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        scale=0.3, size=(4, cfg.window, cfg.in_dim)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        model = emb.make_model(params, cfg, dev)
        z, rec = model(x.to(dev))
        loss = torch.mean((rec - x.to(dev)) ** 2)
        loss.backward()
        out[str(dev)] = (z.detach().cpu(), loss.item(),
                         {n: p.grad.cpu() for n, p in model.named_parameters()})
    (z_c, l_c, g_c), (z_g, l_g, g_g) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(z_g, z_c, atol=1e-5, rtol=1e-5)
    assert abs(l_g - l_c) <= EMB_LOSS_RTOL * abs(l_c)
    num = sum(((g_g[n] - g) ** 2).sum() for n, g in g_c.items())
    assert num.sqrt() <= EMB_GRAD_REL_L2 * sum((g ** 2).sum() for g in g_c.values()).sqrt()


def test_native_loader_batches_reach_the_card_intact(cuda, tmp_path):
    """An epoch of the native loader through the pinned prefetch onto the
    card is bit-equal to the same seed's host batches."""
    import numpy as np

    from amuse_tpu_torch.data.prefetch import prefetch_to_device
    from amuse_tpu_torch.native import loader

    rng = np.random.default_rng(8)
    path = loader.write_abin(tmp_path / "c.abin", {
        "motion": rng.normal(size=(70, 300, 168)).astype(np.float32),
        "actor_id": rng.integers(0, 30, 70).astype(np.int32),
        "con": rng.normal(size=(70, 256)).astype(np.float32)})
    ld = loader.NativeWindowLoader(path)
    got = [{k: v.cpu() for k, v in b.items()}
           for b in prefetch_to_device(ld.epoch(8, seed=5), 3, cuda)]
    want = list(ld.epoch(8, seed=5))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], torch.from_numpy(b[k])) for k in b)


def _rig(path, joints: int, order: str, frames: int, seed: int, root: str = "pelvis"):
    """A chain skeleton with random Euler angles, written as BVH."""
    import numpy as np

    from amuse_tpu_torch.data import bvh

    rng = np.random.default_rng(seed)
    rot = [f"{a}rotation" for a in order]
    js = [bvh.BvhJoint(root, -1, np.zeros(3), ["Xposition", "Yposition", "Zposition", *rot])]
    js += [bvh.BvhJoint(f"j{i}", i - 1, rng.normal(scale=10, size=3), list(rot))
           for i in range(1, joints)]
    data = rng.uniform(-180, 180, size=(frames, 6 + 3 * (joints - 1)))
    bvh.write_bvh(path, bvh.BvhData(js, data, 0.033333))


@pytest.mark.parametrize("order", ["ZXY", "ZYX"])
def test_bvh_to_axis_angle_on_the_card_matches_cpu(cuda, tmp_path, order):
    """The axis-angle conversion of 3,000 frames x 55 joints on the card
    against the CPU, through the rotation matrices (atol 1e-5, float32)."""
    from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
    from amuse_tpu_torch.data import bvh

    _rig(tmp_path / "a.bvh", 55, order, 3000, seed=1)
    parsed = bvh.parse_bvh(tmp_path / "a.bvh")
    (card, trans, names), (cpu, ctrans, cnames) = (bvh.bvh_to_axis_angle(parsed, d)
                                                   for d in (cuda, "cpu"))
    assert card.shape == (3000, 55, 3) and names == cnames and (trans == ctrans).all()
    mats = [axis_angle_to_matrix(torch.from_numpy(x).double()) for x in (card, cpu)]
    torch.testing.assert_close(mats[0], mats[1], atol=1e-5, rtol=0)


def test_host_task_clis_on_the_card_match_cpu(cuda, tmp_path, monkeypatch):
    """bvh2smplx_ (two SMPL-X rigs, a raw skeleton skipped), then render_gt
    and render_baselines over its output, without Blender, on the card and
    with --device cpu: the same npz trees, poses within 1e-5 through their
    rotation matrices, every other array equal."""
    import json

    import numpy as np

    from amuse_tpu_torch.cli import main as cli
    from amuse_tpu_torch.core.rotations import axis_angle_to_matrix

    monkeypatch.setenv("PATH", str(tmp_path))
    for sub in ("2", "9"):
        (tmp_path / "beat" / sub).mkdir(parents=True)
    _rig(tmp_path / "beat/2/2_scott_0_9_9.bvh", 55, "ZYX", 700, seed=2)
    _rig(tmp_path / "beat/2/2_scott_0_10_10.bvh", 55, "ZYX", 310, seed=3)
    _rig(tmp_path / "beat/9/9_miranda_0_9_9.bvh", 75, "ZXY", 5, seed=4, root="Hips")
    (tmp_path / "baselines/camn").mkdir(parents=True)
    trees = {}
    for dev in ("cuda", "cpu"):
        cfg = {"data": {"data_root": str(tmp_path / "beat"), "mosh_root": str(tmp_path / dev),
                        "baselines_root": str(tmp_path / "baselines")},
               "out_dir": str(tmp_path / f"runs_{dev}")}
        (tmp_path / f"{dev}.json").write_text(json.dumps(cfg))
        for task in ("bvh2smplx_", "render_gt", "render_baselines"):
            if task == "render_baselines":
                d = np.load(tmp_path / dev / "2_scott_0_9_9.npz")
                np.savez(tmp_path / "baselines/camn/2_scott_0_9_9.npz",
                         poses=d["poses"].reshape(-1, 165)[::-1], trans=d["trans"])
            cli.main(["--fn", task, "--cfg", str(tmp_path / f"{dev}.json"), "--device", dev])
        trees[dev] = {str(p.relative_to(tmp_path / dev)): p
                      for p in sorted((tmp_path / dev).rglob("*.npz"))}
        # <run>/{GT,camn}/<take>/seq_<i>/<take>.npz of both tasks' runs, keyed without <run>
        trees[dev].update({str(p.relative_to(p.parents[3])): p
                           for p in sorted((tmp_path / f"runs_{dev}").rglob("*.npz"))})
    assert list(trees["cuda"]) == list(trees["cpu"]) and len(trees["cuda"]) > 2
    for rel, p in trees["cuda"].items():
        a, b = np.load(p), np.load(trees["cpu"][rel])
        assert a.files == b.files
        for k in a.files:
            if k == "poses":
                ma, mb = (axis_angle_to_matrix(torch.from_numpy(x)) for x in (a[k], b[k]))
                torch.testing.assert_close(ma, mb, atol=1e-5, rtol=0)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel}:{k}")


# ---- the legacy zoo and MFCC + DTW: no kernel of the port, card against CPU ----
# float32 with TF32 off: forwards within 1e-5 of the CPU's largest magnitude
# (or 1; readings on an H100 to 7.5e-7); MFCC within 5e-4 (cuFFT against
# pocketfft, coefficients of 100-500, near-floor bins of the silent tail;
# reading 2.7e-4); DTW within 1e-6 of the largest cost (reading 1.1e-7)

LEGACY_TOL = 1e-5
MFCC_TOL, DTW_TOL = 5e-4, 1e-6


def _seeded(module, seed):
    from amuse_tpu_torch.models.legacy_family import BatchNorm

    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in module.modules()
             if isinstance(m, (torch.nn.LayerNorm, BatchNorm))}
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g) + (1.0 if id(p) in norms else 0.0))
    return module.eval()


def _legacy_close(got, want):
    flat = (lambda o: [o[k] for k in sorted(o)] if isinstance(o, dict)
            else list(o) if isinstance(o, (tuple, list)) else [o])
    for a, b in zip(flat(got), flat(want)):
        if isinstance(a, (tuple, list, dict)):
            _legacy_close(a, b)
            continue
        scale = max(1.0, b.abs().max().item())
        assert (a.cpu() - b).abs().max().item() <= LEGACY_TOL * scale


def _legacy_members():
    from amuse_tpu_torch.models import actor, audio_legacy, legacy_family as lf, raw_diffusion

    g = torch.Generator().manual_seed(0)
    x = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    ids = lambda high, *s: torch.randint(0, high, s, generator=g)  # noqa: E731
    return {
        "diffusion": (raw_diffusion.RawPoseDenoiser(raw_diffusion.RawDenoiserConfig(
            nfeats=12, latent_dim=16, ff_size=32, num_layers=2, num_heads=2, cond_dim=8,
            window=6, dropout=0.0)), (x(3, 6, 12), ids(1000, 3), x(3, 8), x(3, 8))),
        "wav_mfcc": (audio_legacy.AutoEncoder3x(audio_legacy.LegacyAudioConfig(
            channels=4, latent_dim=8, in_coeffs=13)), (x(2, 64, 13),)),
        "camn_lstm": (lf.CaMNPoseGenerator(lf.CaMNConfig(
            nfeats=6, latent_dim=8, fusion_dim=8, num_layers=2, audio_dim=4, text_dim=3)),
            (x(2, 9, 6), x(2, 9, 4), ids(8, 2, 9), ids(30, 2, 9), x(2, 9, 3))),
        "faceformer": (lf.FaceformerDecoder(5, 3, 8, 2, 16, 2),
                       (x(2, 30, 5), x(2, 30, 3), ids(30, 2), ids(8, 2))),
        "discriminator": (lf.ConvDiscriminator(3, (4, 6)), (x(2, 7, 3),)),
        "actor_ae": (actor.ActorAE(actor.ActorConfig(
            njoints=2, nfeats=3, num_frames=5, latent_dim=8, ff_size=16, num_layers=2,
            num_heads=2, dropout=0.0)), (x(2, 5, 6), ids(8, 2))),
    }


@pytest.mark.parametrize("tag", ["diffusion", "wav_mfcc", "camn_lstm", "faceformer",
                                 "discriminator", "actor_ae"])
def test_legacy_member_on_the_card_matches_cpu(cuda, tag):
    import copy

    module, args = _legacy_members()[tag]
    module = _seeded(module, 1)
    card = copy.deepcopy(module).to(cuda)
    with torch.no_grad():
        _legacy_close(card(*[a.to(cuda) for a in args]), module(*args))
    if tag == "camn_lstm":  # BatchNorm in train mode: the output and the running statistics
        with torch.no_grad():
            _legacy_close(card.train()(*[a.to(cuda) for a in args]), module.train()(*args))
        for a, b in zip(card.emo_addon.bns, module.emo_addon.bns):
            _legacy_close((a.running_mean, a.running_var), (b.running_mean, b.running_var))


def test_text_encoder_left_padding_on_the_card(cuda):
    """Left padding gives position id -1, which must wrap to the last row on
    the card too (an unwrapped -1 is a device-side assert there)."""
    import copy

    from amuse_tpu_torch.models.legacy_family import TextEncoder

    module = _seeded(TextEncoder(latent_dim=8), 2)
    ids = torch.randint(0, 50257, (3, 7), generator=torch.Generator().manual_seed(3))
    mask = torch.tensor([[1] * 7, [0] * 3 + [1] * 4, [1] * 5 + [0] * 2])
    card = copy.deepcopy(module).to(cuda)
    with torch.no_grad():
        out = card(ids.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
        _legacy_close(out, module(ids, mask))


def test_raw_train_steps_and_samplers_on_the_card_match_cpu(cuda):
    """Three raw-diffusion steps with injected draws (losses, parameters, the
    key biases apart, the loss-aware state), then both samplers at T = 50."""
    from amuse_tpu_torch.diffusion import gaussian as G
    from amuse_tpu_torch.models.raw_diffusion import RawDenoiserConfig
    from amuse_tpu_torch.train import raw_diffusion as tr

    cfg_m = RawDenoiserConfig(nfeats=12, latent_dim=16, ff_size=32, num_layers=2, num_heads=2,
                              cond_dim=8, window=6, dropout=0.0)
    cfg = tr.RawTrainConfig(num_timesteps=50)
    states = {d: tr.init_state(0, cfg_m, cfg, d) for d in ("cpu", cuda)}
    step, sample_fn = tr.make_train_step(cfg_m, cfg)
    g = torch.Generator().manual_seed(4)
    batch = {"motion": 0.3 * torch.randn((8, 6, 12), generator=g),
             "con": torch.randn((8, 8), generator=g), "emo": torch.randn((8, 8), generator=g)}
    for _ in range(3):
        draw = tr.RawStepDraw(torch.randint(0, 50, (8,), generator=g),
                              torch.randn((8, 6, 12), generator=g))
        logs = {d: step(s, {k: v.to(d) for k, v in batch.items()}, None,
                        tr.RawStepDraw(*(v.to(d) for v in draw))) for d, s in states.items()}
        assert abs(logs[cuda]["loss"].item() / logs["cpu"]["loss"].item() - 1) <= 1e-5
    cpu_p = dict(states["cpu"].model.named_parameters())
    for name, p in states[cuda].model.named_parameters():
        a, b = p.detach().cpu(), cpu_p[name].detach()
        if name.endswith("in_proj_bias"):  # the key bias: zero gradient, Adam moves it +-lr
            assert (a[16:32] - b[16:32]).abs().max() <= 6e-4
            a, b = torch.cat([a[:16], a[32:]]), torch.cat([b[:16], b[32:]])
        assert (a - b).abs().max() <= 1e-6, name
    assert torch.equal(states[cuda].sampler_state.counts.cpu(), states["cpu"].sampler_state.counts)
    _legacy_close(states[cuda].sampler_state.loss_sq_history,
                  states["cpu"].sampler_state.loss_sq_history)
    noise = torch.randn((51, 2, 6, 12), generator=g)
    cond = {"con": batch["con"][:2], "emo": batch["emo"][:2]}
    out = {d: sample_fn(states[d].model, {k: v.to(d) for k, v in cond.items()},
                        noise=noise.to(d)) for d in ("cpu", cuda)}
    _legacy_close(out[cuda], out["cpu"])
    for d in ("cpu", cuda):
        model, c = states[d].model, {k: v.to(d) for k, v in cond.items()}
        with torch.no_grad():
            out[d] = G.ddim_sample_loop(tr.make_diffusion(cfg, d),
                                        lambda xt, tt: model(xt, tt, c["con"], c["emo"]),
                                        (2, 6, 12), 10, noise=noise[0].to(d))
    _legacy_close(out[cuda], out["cpu"])


def test_mfcc_and_dtw_on_the_card_match_cpu(cuda):
    from amuse_tpu_torch.audio import mfcc as M

    g = torch.Generator().manual_seed(5)
    s = torch.arange(32_000) / 16_000.0
    waves = 0.3 * torch.sin(2 * 3.14159 * 220.0 * s) + 0.02 * torch.randn((3, 32_000), generator=g)
    waves[2, 16_000:] = 0.0  # a silent tail
    got, want = M.mfcc(waves.to(cuda)), M.mfcc(waves)
    mfcc_err = (got.cpu() - want).abs().max().item()
    acc, ref = M.dtw_cost(want[0].to(cuda), want[2].to(cuda)), M.dtw_cost(want[0], want[2])
    dtw_err = ((acc.cpu() - ref).abs().max() / ref.abs().max()).item()
    assert mfcc_err <= MFCC_TOL and dtw_err <= DTW_TOL, (mfcc_err, dtw_err)


# ---- data parallelism (parallel/mesh.py) on the one card ----------------------


def _dist_workers():
    """tests/torch_port_dist.py, imported from this directory: an installed
    package named ``tests`` may shadow it (the spawned ranks inherit the path)."""
    here = str(Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_port_dist

    return torch_port_dist


def test_world1_nccl_sync_is_the_identity(cuda, tmp_path, monkeypatch):
    """One NCCL rank (the launcher's environment at world size 1): a small
    stage-1 step's gradients (K1, K2) leave the all-reduce divided by 1 bit
    for bit, and so do the logs' means; the step with the sync equals the
    plain step given the same gradients."""
    import copy

    import torch.distributed as dist

    from amuse_tpu_torch.ops import attention
    from amuse_tpu_torch.parallel import mesh as M
    from amuse_tpu_torch.train import audio as ta
    D = _dist_workers()

    monkeypatch.setenv("NCCL_SOCKET_IFNAME", os.environ.get("NCCL_SOCKET_IFNAME", "lo"))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.setenv(k, "1" if k == "WORLD_SIZE" else "0")
    dev = M.initialize_distributed("cuda", init_method=f"file://{tmp_path}/process_group")
    try:
        assert dist.get_backend() == "nccl" and dev == torch.device("cuda", 0)
        mesh = M.make_mesh()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(11)
            model = D.ASTDisentangler(D.ASTConfig(**D.AST_KW), fusion_dim=64).to(dev)
        twin = copy.deepcopy(model)
        state = ta.AudioTrainState(model, ta.make_optimizer(model, D.ACFG))
        plain = ta.AudioTrainState(twin, ta.make_optimizer(twin, D.ACFG))
        seen = {}

        class Recorded(M.GradSync):
            def all_reduce(self, params):
                params = list(params)
                seen["before"] = [p.grad.clone() if p.grad is not None else None for p in params]
                super().all_reduce(params)
                seen["same"] = all(b is None and p.grad is None or torch.equal(b, p.grad)
                                   for b, p in zip(seen["before"], params))

        step, _ = ta.make_train_step(D.ACFG, Recorded(mesh))
        batch = ta.batch_to_device(D.stage1_batch(2, 1, 64, 32), dev)
        before = attention.mha.launches
        for i in range(2):
            logs = step(state, batch, ta.step_generator(6, 0, i, dev))
            assert seen["same"]
            for p, g in zip(twin.parameters(), seen["before"]):
                p.grad = g
            ta.fill_missing_grads(twin, D.ACFG.frame_based_feats)
            plain.optimizer.step()
        assert attention.mha.launches - before == 2 * D.AST_KW["depth"]
        for (n, a), b in zip(model.named_parameters(), twin.parameters()):
            assert torch.equal(a, b), n
        assert all(torch.equal(a, b) for a, b in zip(M.mean_logs(logs, mesh).values(),
                                                       logs.values()))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_on_the_card_equal_one_process(cuda, tmp_path, monkeypatch):
    """Two gloo ranks sharing the card against one process on it at the same
    global batch (tests/test_torch_port_parallel.py's bounds,
    ``torch_port_dist.errors``: losses rtol 1e-5, first-step gradients 1e-4
    of their largest entry, first-step parameters lr/10 where its gradient
    exceeds 1e-6; bit-equal across the ranks): the small LPDM steps with and
    without dropout (K3 twice a rank), the stage-1 steps with and without
    augmentation and dropout (K1 and K2 twice a rank), the sharded fbank and
    encode (within 1e-5 of one call). The planted faults (each rank on its
    own rows' gradient; each rank's dropout masks from its own generator)
    fall outside those bounds."""
    D = _dist_workers()

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    ranks = D.run_ranks(D.suite, 2, tmp_path, device="cuda:0", backend="gloo")
    one = {"lpdm": D.lpdm_steps(None, cuda), "stage1": D.stage1_steps(None, cuda),
           "lpdm_dropout": D.lpdm_steps(None, cuda, dropout=0.1),
           "stage1_augmented": D.stage1_steps(None, cuda, stochastic=True, dropout=0.1),
           "encode": D.fbank_and_encode(None, cuda)}
    for key in ("lpdm", "lpdm_dropout", "stage1", "stage1_augmented"):
        a, b = (r[key] for r in ranks)
        assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"]), key
        for r in (a, b):
            err = D.errors(r, one[key])
            assert D.within(err), (key, err)
    for key in ("lpdm", "stage1"):
        for r in ranks:
            assert not D.within(D.errors(r[f"{key}_fault"], one[key])), key
    for r in ranks:
        assert not D.within(D.errors(r["lpdm_local_masks"], one["lpdm_dropout"]))
        assert r["lpdm"]["launches"]["ddim_sampler"] == 2
        for key in ("stage1", "stage1_augmented"):
            assert r[key]["launches"]["attention_fwd"] == 2 * D.AST_KW["depth"]
            assert r[key]["launches"]["attention_bwd"] == 2 * D.AST_KW["depth"]
        assert r["encode"]["launches"]["attention_fwd"] == 1
        for k in ("fbank", "con", "emo", "sty"):
            torch.testing.assert_close(r["encode"][k], one["encode"][k], atol=1e-5, rtol=0)


# The attention kernel variants (ops/kernel_variants.py), each kernel against
# its plain version under kernel_variants.kernel_limit (and the v4 backward's
# relative L2), a bf16 softmax forward bit-equal on KERNEL_BIT_EQUAL_SHARE of
# its entries. The bf16 edges of the wgmma kernels' tiling, at B*H = 1 and
# 48: one key; a 64-row tile and the ring's ragged tail on either side of
# it; a 128-row block whose second warpgroup lies wholly past S (S <= 64,
# 129) or not at all (128); the harness's S and a long one.
VARIANT_EDGE_S = (1, 63, 64, 127, 128, 129, 1214, 2048)
VARIANT_CASES = [(torch.float32, (2, 2, 333, 64)), (torch.bfloat16, (4, 12, 1214, 64)),
                 (torch.bfloat16, (1, 3, 65, 64))] + [
    (torch.bfloat16, (b, h, s, 64)) for s in VARIANT_EDGE_S for b, h in ((1, 1), (4, 12))]


def _variant_inputs(cuda, dtype, shape, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [(torch.randn(shape, generator=g, device=cuda) * (0.5 if i < 3 else 1.0)).to(dtype)
            for i in range(4)]


@pytest.mark.parametrize("body", ["softmax", "dots"])
@pytest.mark.parametrize("dtype,shape", VARIANT_CASES)
def test_variant_fwd_kernel_matches_plain(cuda, dtype, shape, body):
    """csrc/attention_variants_fwd.cu against variant_fwd_reference at the
    chip_smoke shapes (and a ragged S of 65), one launch counted, a rerun
    bit-equal, a bf16 forward (softmax, dots) bit-equal to the plain version
    on the share the module asks."""
    from amuse_tpu_torch.ops import kernel_variants as kv

    q, k, v, _ = _variant_inputs(cuda, dtype, shape, 3)
    before = kv.variant_fwd.launches
    out = kv.variant_fwd(q, k, v, body)
    again = kv.variant_fwd(q, k, v, body)
    torch.cuda.synchronize()
    assert kv.variant_fwd.launches == before + 2
    ref = kv.variant_fwd_reference(q, k, v, body).float()
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out.float()).all()
    err = (out.float() - ref).abs().max().item()
    assert err <= kv.kernel_limit(dtype, body, ref.abs().max().item()), err
    assert torch.equal(out, again)
    if dtype == torch.bfloat16:
        share = kv.bit_equal_share(out.float(), ref)
        assert share >= kv.KERNEL_BIT_EQUAL_SHARE, share


def test_dots_kernel_refuses_a_scale_not_a_power_of_two(cuda):
    """The bf16 dots kernel applies the scale to the float32 output, which
    equals the TPU body's rounding only for a power of two: its C entry
    returns cudaErrorInvalidValue (1) for 0.13 and launches nothing."""
    import ctypes

    from amuse_tpu_torch.ops import _build
    from amuse_tpu_torch.ops import kernel_variants as kv

    q = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16, device=cuda)
    out = torch.full_like(q, 1.0)
    lib = _build.load("attention_variants_fwd")
    for scale, want in ((0.13, 1), (kv.SCALE, 0)):
        rc = lib.variant_fwd(*(ctypes.c_void_p(t.data_ptr()) for t in (q, q, q, out)), 1,
                             kv.FWD_BODIES["dots"], 1, 1, 64, ctypes.c_float(scale),
                             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        assert rc == want, (scale, rc)
        assert out.eq(1.0 if want else 0.0).all()


@pytest.mark.parametrize("body", ["v1", "v4", "v0"])
@pytest.mark.parametrize("dtype,shape", VARIANT_CASES)
def test_variant_bwd_kernel_matches_plain(cuda, dtype, shape, body):
    """csrc/attention_variants_bwd.cu against variant_bwd_reference, each
    gradient under its limit (and v4's relative L2), a rerun bit-equal."""
    from amuse_tpu_torch.ops import kernel_variants as kv

    q, k, v, do = _variant_inputs(cuda, dtype, shape, 4)
    before = kv.variant_bwd.launches
    got = kv.variant_bwd(q, k, v, do, body)
    again = kv.variant_bwd(q, k, v, do, body)
    torch.cuda.synchronize()
    assert kv.variant_bwd.launches == before + 2
    for name, g, ref, rerun in zip(("dq", "dk", "dv"), got,
                                   kv.variant_bwd_reference(q, k, v, do, body), again):
        ref = ref.float()
        assert g.dtype == dtype and torch.isfinite(g.float()).all(), name
        err = (g.float() - ref).abs().max().item()
        assert err <= kv.kernel_limit(dtype, body, ref.abs().max().item()), (name, err)
        if body == "v4":  # relative L2, written so that a zero gradient (S = 1: dq) must match
            assert (g.float() - ref).norm().item() <= kv.KERNEL_V4_REL_L2 * ref.norm().item(), name
        assert torch.equal(g, rerun), name


def test_variant_chain_launch_counts(cuda):
    """One 12-call chain of each variant: 12 forward and 12 backward launches,
    none of K1 or K2; the loss and gradient finite."""
    from amuse_tpu_torch.ops import attention
    from amuse_tpu_torch.ops import kernel_variants as kv

    x = (torch.randn((1, 2, 200, 64), device=cuda) * 0.05).to(torch.bfloat16)
    for name in kv.VARIANTS:
        counts = (kv.variant_fwd.launches, kv.variant_bwd.launches, attention.mha.launches,
                  attention.mha_bwd.launches)
        loss, grad = kv.chain(kv.make_variant(name))(x)
        torch.cuda.synchronize()
        assert (kv.variant_fwd.launches - counts[0], kv.variant_bwd.launches - counts[1],
                attention.mha.launches - counts[2], attention.mha_bwd.launches - counts[3]) \
            == (12, 12, 0, 0), name
        assert torch.isfinite(loss) and torch.isfinite(grad.float()).all(), name


def test_variant_kernels_refuse_what_they_do_not_take(cuda):
    from amuse_tpu_torch.ops import kernel_variants as kv

    q = torch.zeros((1, 1, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim 32"):
        kv.variant_fwd(q, q, q, "softmax")
    q = torch.zeros((1, 1, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kv.variant_bwd(q.half(), q.half(), q.half(), q.half(), "v4")
    with pytest.raises(ValueError, match="one device"):
        kv.variant_fwd(q, q.cpu(), q, "softmax")


def _split_model(q, k, v, do, body, pieces):
    """(dq, dk, dv) of the v1 or v0 body in float64, its float32 operands
    (ds, and e / r or s) held as the bf16 kernels hold them: rounded to
    float32, then the first ``pieces`` of their exact three-piece bf16 split;
    every product exact."""
    from amuse_tpu_torch.ops import kernel_variants as kv

    f64 = torch.float64
    q, k, v, do = (t.to(f64) for t in (q, k, v, do))
    s = q @ k.transpose(-1, -2) * kv.SCALE
    if body == "v0":
        ds, p = do @ v.transpose(-1, -2) * kv.SCALE, s
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True))
        r = e.sum(-1, keepdim=True)
        dp = do @ v.transpose(-1, -2)
        ds = e * (dp - (dp * e).sum(-1, keepdim=True) / r) / r * kv.SCALE
        p = e / r

    def split(x):
        rest, kept = x.to(torch.float32), torch.zeros_like(x)
        for _ in range(pieces):
            piece = rest.to(torch.bfloat16).to(torch.float32)
            kept, rest = kept + piece.to(f64), rest - piece
        return kept

    ds, p = split(ds), split(p)
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


@pytest.mark.parametrize("body", ["v1", "v0"])
def test_cancellation_cases_need_three_pieces(body):
    """On the CPU: each cancellation case of kernel_variants breaks
    kernel_limit at bf16 in the gradients it targets where the float32
    operands are multiplied in two bf16 pieces, and keeps every gradient
    within half the limit in three (the kernels' split), both against the
    plain version in float32: the case tells the two apart."""
    from amuse_tpu_torch.ops import kernel_variants as kv

    for case in kv.CANCELLATION_CASES[body]:
        q, k, v, do = kv.cancellation_inputs(case)
        refs = kv.variant_bwd_reference(*(t.float() for t in (q, k, v, do)), body)
        two, three = (_split_model(q, k, v, do, body, n) for n in (2, 3))
        for name, ref, a2, a3 in zip(("dq", "dk", "dv"), refs, two, three):
            limit = kv.kernel_limit(torch.bfloat16, body, ref.abs().max().item())
            err2, err3 = ((a.float() - ref).abs().max().item() / limit for a in (a2, a3))
            assert err3 <= 0.5, (case, name, err3)
            if name in kv.CANCELLATION_TARGETS[case]:
                assert err2 > 1.5, (case, name, err2)


@pytest.mark.parametrize("body", ["v1", "v0"])
def test_variant_bwd_kernel_passes_the_cancellation_cases(cuda, body):
    """The bf16 v1 and v0 backward kernels on the cancellation cases, against
    the plain version under the unchanged limit, a rerun bit-equal."""
    from amuse_tpu_torch.ops import kernel_variants as kv

    for case in kv.CANCELLATION_CASES[body]:
        q, k, v, do = (t.to(cuda) for t in kv.cancellation_inputs(case))
        got, again = kv.variant_bwd(q, k, v, do, body), kv.variant_bwd(q, k, v, do, body)
        torch.cuda.synchronize()
        for name, g, ref, rerun in zip(("dq", "dk", "dv"), got,
                                       kv.variant_bwd_reference(q, k, v, do, body), again):
            ref = ref.float()
            err = (g.float() - ref).abs().max().item()
            assert err <= kv.kernel_limit(torch.bfloat16, body, ref.abs().max().item()), \
                (case, name, err)
            assert torch.equal(g, rerun), (case, name)


@pytest.mark.parametrize("body", ["v1", "v4", "v0"])
def test_variant_bwd_bf16_runs_on_the_wgmma_kernels(cuda, body):
    """A bf16 call launches the body's wgmma kernels and a float32 call the
    FMA kernels: the route the C entry point reports and the kernels the
    profiler records (up to three tries: a trace can miss a launch)."""
    from torch.profiler import ProfilerActivity, profile

    from amuse_tpu_torch.ops import kernel_variants as kv

    for dtype, route, names in ((torch.bfloat16, "wgmma",
                                 {f"{body}_rows_wgmma", f"{body}_cols_wgmma"}),
                                (torch.float32, "fma", {"rows_f32", "cols_f32"})):
        q, k, v, do = _variant_inputs(cuda, dtype, (1, 2, 200, 64), 5)
        before = dict(kv.variant_bwd.routes)
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                kv.variant_bwd(q, k, v, do, body)
                torch.cuda.synchronize()
            seen = {e.key for e in prof.key_averages()}
            if all(any(n in key for key in seen) for n in names):
                break
        assert all(any(n in key for key in seen) for n in names), (dtype, sorted(seen))
        other = {"wgmma": "_f32", "fma": "_wgmma"}[route]
        assert not any(other in key for key in seen), (dtype, sorted(seen))
        calls = kv.variant_bwd.routes[route] - before[route]
        assert 1 <= calls <= 3 and sum(kv.variant_bwd.routes.values()) - sum(before.values()) \
            == calls, (dtype, kv.variant_bwd.routes, before)
