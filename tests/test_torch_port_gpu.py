"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
only torch and the port, so it runs where JAX is absent; the repository's
conftest.py imports JAX, so on the GPU machine run it with

    python -m pytest tests/test_torch_port_gpu.py --noconftest -m gpu -q
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the H100)")
    from amuse_tpu_torch.device import resolve_device

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
