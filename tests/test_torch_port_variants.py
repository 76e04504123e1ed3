"""The attention kernel variants V1-V5 (``benchmarks/kernel_variants.py``)
against the port's ``ops/kernel_variants.py`` (CPU).

The JAX file's ``pl.pallas_call`` passes no ``interpret`` flag, so each test
swaps its module's ``pl`` for a namespace whose ``pallas_call`` runs in
interpret mode, for the test's duration only, and builds the ``make_*``
functions inside the test (each is a fresh ``jax.jit``, traced under the
swap). Nothing under ``benchmarks/`` changes. Inputs and cotangents are
made with numpy from a seed and handed to both packages; the port's CPU
path is its plain versions behind the same ``torch.autograd.Function`` that
launches the kernels on the card.

Limits, each beside the readings taken on the CPU when it was written:

  * bf16 outputs: 2^-8 of the largest output (read: v0 bit-equal, the
    softmax bodies up to 1.24e-3: e rounded to bf16 flips where the two
    frameworks' float32 scores differ in the last bit), and bit-equal on at
    least 0.99 of the entries (read: 0.99930-1.0; ``mha_reference``, which
    rounds P = e / r where the JAX bodies round e, reads 0.525 and 2.9e-3
    of the largest output, so only the share tells the two apart);
  * bf16 gradients: 1e-3 of the largest entry (read: up to 9.2e-4, dq of
    v3, a one-ulp flip of an entry near 0.19 from the float32 summation
    order);
  * float32, the v1/v3/v0 bodies and every forward: 1e-5 of the largest
    entry (read: at most 2.9e-7);
  * float32, the v4/v5 backward (dS and P/r rounded to bf16, so a few
    roundings flip): 2e-3 of the largest entry and relative L2 1e-4 (read:
    1.0e-4 and 8.9e-6).
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import benchmarks.kernel_variants as kv
from amuse_tpu_torch.ops import kernel_variants as tkv
from amuse_tpu_torch.ops.attention import mha_reference

# the port's variant name -> the JAX file's constructor
JAX_MAKERS = {
    "v1_divfold": lambda: kv.make_variant(kv._fwd_kernel_v1, kv._bwd_kernel_v1),
    "v0_dotsonly": lambda: kv.make_variant(kv._fwd_kernel_v0, kv._bwd_kernel_v0),
    "v3_headloop": kv.make_v3,
    "v4_bf16dots": lambda: kv.make_variant(kv._fwd_kernel_v4, kv._bwd_kernel_v4),
    "v5_fullq_fwd": kv.make_v5,
}
SHAPES = {"bfloat16": (1, 2, 100, 64), "float32": (2, 2, 333, 64)}
F32_TOL = 1e-5
BF16_OUT_TOL, BF16_OUT_SHARE = 2.0**-8, 0.99
BF16_GRAD_TOL = 1e-3
F32_V4_GRAD_TOL, F32_V4_GRAD_L2 = 2e-3, 1e-4


@pytest.fixture
def interpret(monkeypatch):
    """The JAX file's ``pl`` with ``pallas_call`` in interpret mode."""
    ns = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(kv, "pl", ns)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _jax(name, arrays, dtype):
    q, k, v, do = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays)
    out, vjp = jax.vjp(JAX_MAKERS[name](), q, k, v)
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (out, *vjp(do))]


def _port(name, arrays, dtype):
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tkv.make_variant(name)(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return [t.detach().float().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(tkv.VARIANTS))
def test_variant_matches_jax_kernel(interpret, name, dtype):
    """Forward output and dq, dk, dv (jax.vjp against torch.autograd.grad,
    one numpy cotangent) at a ragged S: bf16 (1, 2, 100, 64), float32
    (2, 2, 333, 64), under the limits of the module docstring."""
    arrays = _inputs(SHAPES[dtype], dtype, seed=len(name) + len(dtype))
    want, got = _jax(name, arrays, dtype), _port(name, arrays, dtype)
    bf16_body = tkv.VARIANTS[name][1] == "v4"
    for what, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        assert g.shape == w.shape and np.isfinite(g).all(), what
        err, top = np.abs(g - w), np.abs(w).max()
        if dtype == "bfloat16" and what == "out":
            assert err.max() <= BF16_OUT_TOL * top, (what, err.max() / top)
            assert (g == w).mean() >= BF16_OUT_SHARE, (what, (g == w).mean())
        elif dtype == "bfloat16":
            assert err.max() <= BF16_GRAD_TOL * top, (what, err.max() / top)
        elif bf16_body and what != "out":
            assert err.max() <= F32_V4_GRAD_TOL * top, (what, err.max() / top)
            l2 = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert l2 <= F32_V4_GRAD_L2, (what, l2)
        else:
            assert err.max() <= F32_TOL * top, (what, err.max() / top)


def test_bit_equal_share_tells_the_rounding_points_apart(interpret):
    """The bf16 share check has teeth: at (1, 2, 100, 64) the port's plain
    softmax body (e rounded to bf16 against the row's final maximum, as the
    JAX kernel does) equals V1's output bit for bit on at least
    BF16_OUT_SHARE of its entries, while ``ops.attention.mha_reference``,
    which rounds P = e / r instead, meets the same error limit and falls
    short of the share."""
    arrays = _inputs(SHAPES["bfloat16"], "bfloat16", seed=7)
    want = _jax("v1_divfold", arrays, "bfloat16")[0]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3])
    top = np.abs(want).max()
    for plain, passes in ((tkv.variant_fwd_reference(q, k, v, "softmax"), True),
                          (mha_reference(q, k, v), False)):
        got = plain.float().numpy()
        share = (got == want).mean()
        assert np.abs(got - want).max() <= BF16_OUT_TOL * top
        assert (share >= BF16_OUT_SHARE) == passes, share


def test_chain_matches_jax(interpret):
    """The 12-call chain's loss and gradient (lines 477-487 of the JAX file)
    for v4_bf16dots at (1, 1, 40, 64) bf16: loss rtol 1e-3 (bf16 outputs fed
    back 12 times; read 2.3e-7) and the gradient within 2e-2 of its largest
    entry (read 4.8e-3)."""
    x = np.random.default_rng(5).normal(size=(1, 1, 40, 64)).astype(np.float32) * 0.5
    jloss, jgrad = kv.chain(JAX_MAKERS["v4_bf16dots"]())(jnp.asarray(x, jnp.bfloat16))
    loss, grad = tkv.chain(tkv.make_variant("v4_bf16dots"))(
        torch.from_numpy(x).to(torch.bfloat16))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-3)
    want = np.asarray(jnp.asarray(jgrad, jnp.float32))
    err = np.abs(grad.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err / np.abs(want).max()


def test_dots_scale_folds_into_the_output():
    """The bf16 dots kernel forms P = bf16(s) and multiplies the float32 O by
    SCALE at the store. SCALE is a power of two, so that equals the plain
    version (P = bf16(s * SCALE)) bit for bit before the final cast: on
    seeded (2, 2, 40, 64) bf16 inputs whose first key gives half the rows
    scores in bf16's largest binade [2^127, 2^128), the rest scores near 1.
    A scale that is not a power of two (0.13) breaks the equality.

    The largest score, 1.96 * 2^127, stays below bf16's overflow edge
    (2 - 2^-8) * 2^127 on purpose: at or past it bf16(s) is inf while
    bf16(s * SCALE) is finite, so the fold holds only below it. v is clipped
    for the same reason, so that the unscaled sum of bf16(s) v stays below
    float32's largest value."""
    assert math.frexp(tkv.SCALE)[0] == 0.5
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(2, 2, 40, 64)) for _ in range(3))
    q[:, :, ::2, 0] = 2.0**63 * rng.uniform(1.0, 1.4, size=(2, 2, 20))
    k[:, :, 0, 0] = 2.0**64 * rng.uniform(1.0, 1.4, size=(2, 2))
    k[:, :, 0, 1:] = 0.0
    v = np.clip(v, -2.0, 2.0) / 4  # |O| stays below 2^127 before the scale
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v))
    s = q @ k.transpose(-1, -2)
    assert s.abs().max() >= 2.0**127 and torch.isfinite(s).all()

    def bf16(x):
        return x.to(torch.bfloat16).float()

    def plain(scale):
        return bf16(s * scale) @ v

    def folded(scale):
        return (bf16(s) @ v) * scale

    assert torch.isfinite(folded(tkv.SCALE)).all()
    assert torch.equal(plain(tkv.SCALE), folded(tkv.SCALE))
    assert torch.equal(plain(tkv.SCALE).to(torch.bfloat16),
                       tkv.variant_fwd_reference(*(x.to(torch.bfloat16) for x in (q, k, v)),
                                                 "dots"))
    assert not torch.equal(plain(0.13), folded(0.13))


def test_counters_stay_on_the_cpu_path():
    """The CPU path runs the plain versions: no launch is counted."""
    before = (tkv.variant_fwd.launches, tkv.variant_bwd.launches)
    x = torch.randn((1, 1, 8, 64), requires_grad=True)
    tkv.chain(tkv.make_variant("v1_divfold"))(x)
    assert (tkv.variant_fwd.launches, tkv.variant_bwd.launches) == before


def test_head_dim_32_and_unknown_bodies_are_refused():
    q = torch.zeros((1, 1, 8, 32))
    with pytest.raises(ValueError, match="head dim 32"):
        tkv.variant_fwd(q, q, q, "softmax")
    with pytest.raises(ValueError, match="head dim 32"):
        tkv.variant_bwd(q, q, q, q, "v1")
    q = torch.zeros((1, 1, 8, 64))
    with pytest.raises(ValueError, match="forward body"):
        tkv.variant_fwd(q, q, q, "v1")
    with pytest.raises(ValueError, match="backward body"):
        tkv.variant_bwd(q, q, q, q, "softmax")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tkv.variant_fwd(q.half(), q.half(), q.half(), "softmax")


@pytest.mark.parametrize("argv", [[], ["--device", "cpu"]])
def test_main_needs_cuda(argv, monkeypatch):
    """The entry point times the kernels: without a CUDA card, or asked for
    the CPU, it raises before printing anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tkv.main(argv)
