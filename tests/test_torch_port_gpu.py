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
