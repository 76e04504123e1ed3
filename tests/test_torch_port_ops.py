"""The plain versions of the port's two kernels against the JAX package (CPU).

K1 (``amuse_tpu_torch.ops.attention.mha``) and K3
(``amuse_tpu_torch.ops.denoiser_kernel.ddim_sample_fused``) take their plain
PyTorch version for CPU tensors; these tests hold those against the JAX
reference and against the JAX Pallas kernels run in interpret mode, mirroring
tests/test_ops.py and tests/test_denoiser_kernel.py. The CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.diffusion import ddim_sample as jddim_sample
from amuse_tpu.diffusion import make_schedule as jmake_schedule
from amuse_tpu.diffusion.schedulers import ddim_step as jddim_step
from amuse_tpu.diffusion.schedulers import ddim_timesteps as jddim_timesteps
from amuse_tpu.models.denoiser import Denoiser as JDenoiser
from amuse_tpu.models.denoiser import DenoiserConfig as JDenoiserConfig
from amuse_tpu.ops import denoiser_kernel as jdk
from amuse_tpu.ops.attention import mha_pallas, mha_reference
from amuse_tpu_torch import convert
from amuse_tpu_torch.diffusion.schedulers import make_schedule
from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from amuse_tpu_torch.ops import attention as tatt
from amuse_tpu_torch.ops import denoiser_kernel as tdk


# sequence lengths at the edges of the CUDA kernels' 64- and 128-row tiles
TILE_EDGES = [1, 63, 64, 65, 127, 128, 129, 257]


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


class TestAttentionPlain:
    @pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 2, 70, 32)])
    def test_float32_matches_jax(self, shape):
        """float32, aligned and ragged S: atol 2e-5 (the JAX kernel test's bound)."""
        q, k, v = _qkv(sum(shape), shape)
        mine = tatt.mha(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
        ref = np.asarray(mha_reference(*(jnp.asarray(a) for a in (q, k, v))))
        pallas = np.asarray(mha_pallas(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
        np.testing.assert_allclose(mine, ref, atol=2e-5)
        np.testing.assert_allclose(mine, pallas, atol=2e-5)

    def test_bf16_matches_jax(self):
        """bfloat16: P is rounded to bf16 before P V on both sides; atol 3e-2
        (tests/test_ops.py's bound for the bf16 kernel)."""
        q, k, v = _qkv(3, (1, 1, 128, 64))
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        mine = tatt.mha(tq, tk, tv)
        assert mine.dtype == torch.bfloat16
        ref = np.asarray(mha_reference(jq, jk, jv), np.float32)
        pallas = np.asarray(mha_pallas(jq, jk, jv, interpret=True), np.float32)
        np.testing.assert_allclose(mine.float().numpy(), ref, atol=3e-2)
        np.testing.assert_allclose(mine.float().numpy(), pallas, atol=3e-2)

    @pytest.mark.parametrize("d", [32, 64])
    @pytest.mark.parametrize("s", TILE_EDGES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tile_edge_lengths_match_jax(self, dtype, s, d):
        """Sequence lengths around the 64- and 128-row tiles of the CUDA
        kernels (one row, one short of a tile, a tile, one over, several
        tiles and a ragged tail): the plain version against the JAX
        reference and the Pallas kernel in interpret mode. float32 atol 2e-5,
        bfloat16 atol 3e-2 (tests/test_ops.py's bounds)."""
        q, k, v = _qkv(1000 * d + s, (1, 2, s, d))
        tdtype, jdtype, atol = ((torch.float32, jnp.float32, 2e-5) if dtype == "float32"
                                else (torch.bfloat16, jnp.bfloat16, 3e-2))
        mine = tatt.mha(*(torch.from_numpy(a).to(tdtype) for a in (q, k, v)))
        assert mine.dtype == tdtype and mine.shape == (1, 2, s, d)
        jq, jk, jv = (jnp.asarray(a, jdtype) for a in (q, k, v))
        ref = np.asarray(mha_reference(jq, jk, jv), np.float32)
        pallas = np.asarray(mha_pallas(jq, jk, jv, interpret=True), np.float32)
        np.testing.assert_allclose(mine.float().numpy(), ref, atol=atol)
        np.testing.assert_allclose(mine.float().numpy(), pallas, atol=atol)

    def test_strided_views_and_cpu_counter(self):
        """The ViT block feeds q/k/v as strided views of the fused qkv output;
        on CPU tensors the wrapper runs the plain version and launches nothing."""
        before = tatt.mha.launches
        qkv = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 70, 3, 2, 32))
                               .astype(np.float32))
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = tatt.mha(q, k, v)
        ref = tatt.mha_reference(q.contiguous(), k.contiguous(), v.contiguous())
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
        assert tatt.mha.launches == before == 0


def test_many_heads_pass_the_checks_and_match_jax():
    """The kernels' grids are one dimension of (batch*head, row tile) pairs,
    so B * H is not held to a grid's second dimension (65535): the wrappers'
    checks take 70,000 heads, and the plain version agrees with the JAX
    reference there (float32, atol 2e-5)."""
    q, k, v = _qkv(9, (35000, 2, 2, 32))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tatt._check(tq, tk, tv)
    ref = np.asarray(mha_reference(*(jnp.asarray(a) for a in (q, k, v))))
    np.testing.assert_allclose(tatt.mha(tq, tk, tv).numpy(), ref, atol=2e-5)


@pytest.fixture(scope="module")
def flagship_denoiser():
    """Flagship dims (9 layers, d 128, ff 512, 4 heads), flax init, carried to the port."""
    cfg = JDenoiserConfig()
    model = JDenoiser(cfg)
    params = model.init(
        jax.random.key(0), jnp.zeros((1, 1, 128)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 256)), jnp.zeros((1, 256)), jnp.zeros((1, 256)),
    )["params"]
    port = Denoiser(DenoiserConfig()).eval()
    port.load_state_dict(convert.denoiser_from_jax(params))
    return cfg, model, params, port


def _conds(seed, b):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, 256)).astype(np.float32) for _ in range(3)]


class TestSamplerPlain:
    def test_packing_matches_jax(self, flagship_denoiser):
        _, _, params, port = flagship_denoiser
        mine, ref = tdk.pack_denoiser(port), jdk.pack_denoiser(params)
        assert mine.wq.shape == (9, 128, 128) and mine.w1.shape == (9, 128, 512)
        assert mine.wskip.shape == (4, 256, 128) and mine.ln_scale.shape == (9, 2, 128)
        for name in tdk.PackedDenoiser._fields:
            np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)

    def test_conditioning_matches_jax(self, flagship_denoiser):
        cfg, _, params, port = flagship_denoiser
        con, emo, sty = _conds(1, 2)
        mine = tdk.precompute_conditioning(port, make_schedule(), *map(torch.from_numpy,
                                                                       (con, emo, sty)))
        ref = jdk.precompute_conditioning(params, cfg, jmake_schedule(), con, emo, sty)
        for m, r, atol in zip(mine, ref, (1e-5, 1e-5, 1e-6, 0)):
            np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=atol)

    def test_matches_fused_kernel_and_scan(self, flagship_denoiser):
        """10 steps at batch 2 from the same initial latents: the plain sampler
        against the Pallas sampler (interpret mode) and the XLA scan, atol
        2e-3 / rtol 1e-2 as tests/test_denoiser_kernel.py (the Pallas kernel's
        polynomial erf and padded tokens against exact erf)."""
        cfg, model, params, port = flagship_denoiser
        b, steps, key = 2, 10, jax.random.key(7)
        con, emo, sty = _conds(0, b)
        x0 = np.array(jax.random.normal(key, (b, 1, 128), jnp.float32))
        pallas = jdk.make_fused_sampler(params, cfg, jmake_schedule(), steps, interpret=True)(
            key, con, emo, sty)
        scan = jddim_sample(
            jmake_schedule(),
            lambda lat, t: model.apply({"params": params}, lat, t, con, emo, sty),
            key, (b, 1, 128), steps, initial_latents=jnp.asarray(x0))
        before = tdk.ddim_sample_fused.launches
        mine = tdk.ddim_sample_fused(port, make_schedule(), *map(torch.from_numpy, (con, emo, sty)),
                                     num_steps=steps, initial_latents=torch.from_numpy(x0))
        assert tdk.ddim_sample_fused.launches == before == 0
        np.testing.assert_allclose(mine.numpy(), np.asarray(scan), atol=2e-3, rtol=1e-2)
        np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), atol=2e-3, rtol=1e-2)

    def test_single_step(self, flagship_denoiser):
        """One step, tight: atol 2e-4 / rtol 1e-4 (tests/test_denoiser_kernel.py)."""
        cfg, model, params, port = flagship_denoiser
        con, emo, sty = _conds(1, 1)
        key = jax.random.key(3)
        x0 = jax.random.normal(key, (1, 1, 128), jnp.float32)
        sched = jmake_schedule()
        ts = jddim_timesteps(sched, 1)
        eps = model.apply({"params": params}, x0, ts, con, emo, sty)
        expected = jddim_step(sched, eps, ts[0], x0, 1)
        mine = tdk.ddim_sample_fused(port, make_schedule(), *map(torch.from_numpy, (con, emo, sty)),
                                     num_steps=1, initial_latents=torch.from_numpy(np.array(x0)))
        np.testing.assert_allclose(mine.numpy(), np.asarray(expected), atol=2e-4, rtol=1e-4)

    def test_missing_streams_and_generator(self, flagship_denoiser):
        """emo/sty None run the same path (3 or 4 real tokens); the plain
        sampler equals the JAX scan over the same initial latents."""
        cfg, model, params, port = flagship_denoiser
        con, _, sty = _conds(2, 2)
        x0 = np.random.default_rng(5).normal(size=(2, 1, 128)).astype(np.float32)
        ref = jddim_sample(
            jmake_schedule(),
            lambda lat, t: model.apply({"params": params}, lat, t, con, None, sty),
            None, (2, 1, 128), 4, initial_latents=jnp.asarray(x0))
        mine = tdk.ddim_sample_fused(port, make_schedule(), torch.from_numpy(con), None,
                                     torch.from_numpy(sty), num_steps=4,
                                     initial_latents=torch.from_numpy(x0))
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
        drawn = tdk.ddim_sample_fused(port, make_schedule(), torch.from_numpy(con), num_steps=2,
                                      generator=torch.Generator().manual_seed(0))
        assert drawn.shape == (2, 1, 128) and torch.isfinite(drawn).all()
        with pytest.raises(ValueError):
            tdk.ddim_sample_fused(port, make_schedule(), torch.from_numpy(con), num_steps=2,
                                  initial_latents=torch.zeros(3, 1, 128))


def test_split_conditioning_matches_jax(flagship_denoiser):
    """The per-schedule part (schedule_conditioning) and the per-call part
    (condition_tokens) together equal precompute_conditioning bit for bit and
    the JAX package's precompute_conditioning (the tolerances of
    test_conditioning_matches_jax); the vectorised coefficient table equals
    the per-timestep ddim_coefficients bit for bit."""
    from amuse_tpu_torch.diffusion.schedulers import (ddim_coefficient_table, ddim_coefficients,
                                                      ddim_timesteps)

    cfg, _, params, port = flagship_denoiser
    con, emo, sty = _conds(4, 2)
    sched = make_schedule()
    split = tdk.schedule_conditioning(port, sched, 50)
    cond = tdk.condition_tokens(port, *map(torch.from_numpy, (con, emo, sty)))
    whole = tdk.precompute_conditioning(port, sched, *map(torch.from_numpy, (con, emo, sty)))
    for mine, ref in zip((split.time_tokens, cond, split.coeffs, split.pos0), whole):
        assert torch.equal(mine, ref)
    ref = jdk.precompute_conditioning(params, cfg, jmake_schedule(), con, emo, sty)
    for m, r, atol in zip(whole, ref, (1e-5, 1e-5, 1e-6, 0)):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=atol)
    for steps in (1, 7, 50):
        loop = torch.stack([ddim_coefficients(sched, t, steps)
                            for t in ddim_timesteps(sched, steps).tolist()])
        assert torch.equal(ddim_coefficient_table(sched, steps), loop)


def test_fused_sampler_with_precomputed_parts(flagship_denoiser):
    """ddim_sample_fused on CPU tensors gives the same latents with and
    without the precomputed per-schedule conditioning and cluster pack."""
    _, _, _, port = flagship_denoiser
    con, emo, sty = map(torch.from_numpy, _conds(6, 2))
    x0 = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 1, 128)).astype(np.float32))
    sched = make_schedule()
    plain = tdk.ddim_sample_fused(port, sched, con, emo, sty, num_steps=3, initial_latents=x0)
    given = tdk.ddim_sample_fused(
        port, sched, con, emo, sty, num_steps=3, initial_latents=x0,
        packed=tdk.SamplerWeights(tdk.pack_denoiser(port)),
        conditioning=tdk.schedule_conditioning(port, sched, 3))
    assert torch.equal(plain, given)


def _unslice(pack, d, ff, layers):
    """The cluster pack's runs -> PackedDenoiser tensors (the inverse of
    pack_for_cluster), cutting each run by stream_segments."""
    c_n, n_skip = pack.cluster, (layers - 1) // 2
    dc, fc = d // c_n, ff // c_n
    out = {name: torch.zeros_like(t) for name, t in zip(
        tdk.PackedDenoiser._fields,
        (torch.zeros(layers, d, d),) * 4 + (torch.zeros(layers, d),) * 4
        + (torch.zeros(layers, d, ff), torch.zeros(layers, ff), torch.zeros(layers, ff, d),
           torch.zeros(layers, d), torch.zeros(layers, 2, d), torch.zeros(layers, 2, d),
           torch.zeros(n_skip, 2 * d, d), torch.zeros(n_skip, d), torch.zeros(d),
           torch.zeros(d)))}
    for c in range(c_n):
        cs, fs = slice(c * dc, (c + 1) * dc), slice(c * fc, (c + 1) * fc)
        pieces = torch.split(pack.weights[c], [s.rows * s.cols for s in
                                               tdk.stream_segments(d, ff, layers, c_n)])
        for seg, flat in zip(tdk.stream_segments(d, ff, layers, c_n), pieces):
            m, i = flat.reshape(seg.rows, seg.cols), seg.index
            if seg.kind == "merge":
                out["wskip"][i][:, cs], out["bskip"][i][cs] = m[:-1], m[-1]
            elif seg.kind == "qkv":
                for j, name in enumerate("qkv"):
                    out[f"w{name}"][i][:, cs] = m[:-1, j * dc:(j + 1) * dc]
                    out[f"b{name}"][i][cs] = m[-1, j * dc:(j + 1) * dc]
            elif seg.kind == "o":
                out["wo"][i][:, cs], out["bo"][i][cs] = m[:-1], m[-1]
            elif seg.kind == "ln1":
                out["ln_scale"][i, 0], out["ln_bias"][i, 0] = m
            elif seg.kind == "ff1":
                out["w1"][i][:, fs], out["b1"][i][fs] = m[:-1], m[-1]
            elif seg.kind == "ff2":
                out["w2"][i][fs, :] = m
            elif seg.kind == "ln2":
                out["b2"][i], out["ln_scale"][i, 1], out["ln_bias"][i, 1] = m
            else:
                out["final_scale"], out["final_bias"] = m[0].clone(), m[1].clone()
    return tdk.PackedDenoiser(**out)


@pytest.mark.parametrize("dims,cluster", [((32, 64, 3, 2), 8), ((32, 64, 3, 2), 2),
                                          ((64, 128, 5, 4), 4), ((128, 512, 9, 4), 8),
                                          ((20, 44, 3, 2), 1)])
def test_cluster_pack_layout(dims, cluster):
    """The per-CTA weight runs the kernel reads: they unslice exactly to
    pack_denoiser's tensors, each run has the length stream_segments gives,
    and plain-torch products over the CTAs' slices (Q|K|V, O, FF1 and the
    merges by output columns, FF2 by K rows with the partials summed in
    rank order) equal the unsliced products (atol 1e-5: FF2's partials are
    summed in another order)."""
    d, ff, layers, heads = dims
    torch.manual_seed(sum(dims))
    den = Denoiser(DenoiserConfig(latent_dim=d, ff_size=ff, num_layers=layers,
                                  num_heads=heads, cond_dim=16)).eval()
    packed = tdk.pack_denoiser(den)
    pack = tdk.pack_for_cluster(packed, cluster)
    segs = tdk.stream_segments(d, ff, layers, cluster)
    assert pack.weights.shape == (cluster, sum(s.rows * s.cols for s in segs))
    back = _unslice(pack, d, ff, layers)
    for name in tdk.PackedDenoiser._fields:
        assert torch.equal(getattr(back, name), getattr(packed, name)), name
    x = torch.randn(5, d)
    h = torch.randn(5, ff)
    xs = torch.randn(5, 2 * d)
    dc, fc = d // cluster, ff // cluster
    runs = [dict(zip([(s.kind, s.index) for s in segs],
                     (f.reshape(s.rows, s.cols) for s, f in zip(
                         segs, torch.split(pack.weights[c], [s.rows * s.cols for s in segs])))))
            for c in range(cluster)]
    for layer in range(layers):
        qkv = torch.cat([x @ r["qkv", layer][:-1] + r["qkv", layer][-1] for r in runs], dim=1)
        by_part = [qkv.reshape(5, cluster, 3, dc)[:, :, j].reshape(5, d) for j in range(3)]
        for got, w, b in zip(by_part, (packed.wq, packed.wk, packed.wv),
                             (packed.bq, packed.bk, packed.bv)):
            torch.testing.assert_close(got, x @ w[layer] + b[layer], atol=1e-5, rtol=0)
        o = torch.cat([x @ r["o", layer][:-1] + r["o", layer][-1] for r in runs], dim=1)
        torch.testing.assert_close(o, x @ packed.wo[layer] + packed.bo[layer], atol=1e-5, rtol=0)
        f1 = torch.cat([x @ r["ff1", layer][:-1] + r["ff1", layer][-1] for r in runs], dim=1)
        torch.testing.assert_close(f1, x @ packed.w1[layer] + packed.b1[layer], atol=1e-5,
                                   rtol=0)
        f2 = sum(h[:, c * fc:(c + 1) * fc] @ runs[c]["ff2", layer] for c in range(cluster))
        torch.testing.assert_close(f2 + runs[0]["ln2", layer][0],
                                   h @ packed.w2[layer] + packed.b2[layer], atol=1e-5, rtol=0)
    for si in range((layers - 1) // 2):
        m = torch.cat([xs @ r["merge", si][:-1] + r["merge", si][-1] for r in runs], dim=1)
        torch.testing.assert_close(m, xs @ packed.wskip[si] + packed.bskip[si], atol=1e-5,
                                   rtol=0)
