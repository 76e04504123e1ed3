"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
only torch and the port, so it runs where JAX is absent; the repository's
conftest.py imports JAX, so on the GPU machine run it with

    python -m pytest tests/test_torch_port_gpu.py --noconftest -m gpu -q
"""

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
