"""The port's raw-pose diffusion baseline against the JAX package (CPU).

``diffusion/gaussian.py``, ``models/raw_diffusion.py`` and
``train/raw_diffusion.py`` at small widths. Every parameter leaf comes from
a seeded numpy normal and reaches both packages as the same numbers
(``convert.legacy_from_jax``); the port is fed JAX's own draws (noise,
timesteps). Tolerances, from readings on this CPU (float32 both sides,
summation order apart):

  * the Gaussian tables, ``respaced_timesteps`` and the loss-aware sampler
    state: bit-equal;
  * one forward, ``q_sample``, the posterior, the loss: 1e-5 (readings
    below 1.5e-6);
  * the samplers at T = 50 with injected noise: 1e-4 (readings to 8e-6);
  * three train steps: losses rtol 1e-5, parameters 1e-6 (readings 5e-7
    and 1.6e-7: Adam's first steps move each parameter by ~lr = 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amuse_tpu.diffusion import gaussian as jg
from amuse_tpu.models import raw_diffusion as jrd
from amuse_tpu.train import raw_diffusion as jtrain
from amuse_tpu_torch.diffusion import gaussian as tg
from amuse_tpu_torch.models import raw_diffusion as trd
from amuse_tpu_torch.train import raw_diffusion as ttrain
from tests.torch_port_legacy_util import load, max_err, random_variables, shapes_of, t

W = dict(nfeats=12, latent_dim=16, ff_size=32, num_layers=2, num_heads=2, cond_dim=8, window=6)
JCFG = jrd.RawDenoiserConfig(dropout=0.0, **W)
TCFG = trd.RawDenoiserConfig(dropout=0.0, **W)
B = 4


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model(jcfg):
    """(the module's jitted apply, its variables' shapes), once per config."""
    m = jrd.RawPoseDenoiser(jcfg)
    shapes = shapes_of(m.init, jnp.zeros((1, W["window"], W["nfeats"])),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, W["cond_dim"])),
                       jnp.zeros((1, W["cond_dim"])))
    return jax.jit(m.apply), shapes


def _model(seed=0, jcfg=JCFG, tcfg=TCFG):
    """(JAX apply, random variables, the port's module holding them)."""
    apply, shapes = _jax_model(jcfg)
    v = random_variables(shapes, seed, scale=0.2)
    return apply, v, load(trd.RawPoseDenoiser(tcfg), "diffusion", v)


@pytest.mark.parametrize("num_timesteps", [50, 1000])
@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_tables_bit_equal(num_timesteps, schedule):
    betas = getattr(jg, f"{schedule}_betas")(num_timesteps)
    np.testing.assert_array_equal(getattr(tg, f"{schedule}_betas")(num_timesteps), betas)
    for name, j, p in zip(jg.GaussianDiffusion._fields, jg.make_gaussian_diffusion(betas),
                          tg.make_gaussian_diffusion(betas)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
    for steps in (1, 7, 50):
        np.testing.assert_array_equal(tg.respaced_timesteps(num_timesteps, steps),
                                      jg.respaced_timesteps(num_timesteps, steps))


def test_q_sample_posterior_and_x0():
    betas = jg.cosine_betas(1000)
    jgd, tgd = jg.make_gaussian_diffusion(betas), tg.make_gaussian_diffusion(betas)
    x0, xt, eps = _x(1, B, 6, 12), _x(2, B, 6, 12), _x(3, B, 6, 12)
    tt = np.array([0, 1, 500, 999])
    j = [jg.q_sample(jgd, x0, tt, eps), jg.q_posterior_mean(jgd, x0, xt, tt),
         jg.predict_x0_from_eps(jgd, xt, tt, eps)]
    p = [tg.q_sample(tgd, t(x0), t(tt), t(eps)), tg.q_posterior_mean(tgd, t(x0), t(xt), t(tt)),
         tg.predict_x0_from_eps(tgd, t(xt), t(tt), t(eps))]
    for name, a, b in zip(("q_sample", "posterior", "x0"), p, j):
        assert max_err(a, b) <= 1e-5 * max(1.0, float(np.abs(b).max())), name


@pytest.mark.parametrize("predict", ["x0", "epsilon"])
def test_training_loss(predict):
    apply, v, port = _model()
    gd_betas = jg.cosine_betas(1000)
    jgd, tgd = jg.make_gaussian_diffusion(gd_betas), tg.make_gaussian_diffusion(gd_betas)
    x0, con, emo = _x(4, B, 6, 12, scale=0.3), _x(5, B, 8), _x(6, B, 8)
    tt = np.array([3, 100, 600, 999])
    rng = jax.random.key(7)
    per, mean = jg.training_loss(jgd, lambda x, s: apply(v, x, s, con, emo), x0, tt, rng, predict)
    noise = np.asarray(jax.random.normal(rng, x0.shape, jnp.float32))
    with torch.no_grad():
        p_per, p_mean = tg.training_loss(tgd, lambda x, s: port(x, s, t(con), t(emo)), t(x0),
                                         t(tt), t(noise), predict)
    np.testing.assert_allclose(p_per.numpy(), np.asarray(per), rtol=1e-5)
    np.testing.assert_allclose(float(p_mean), float(mean), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoiser_forward(dtype):
    """float32 within 1e-5; bf16 compute over float32 parameters within 3e-2
    of the largest output of JAX's bf16 (readings 0.8-1.4e-2 over four seeds,
    where JAX's bf16 sits 0.9e-2 from its float32: both round at their own
    points)."""
    jcfg = jrd.RawDenoiserConfig(dropout=0.0, dtype=getattr(jnp, dtype), **W)
    tcfg = trd.RawDenoiserConfig(dropout=0.0, dtype=getattr(torch, dtype), **W)
    apply, v, port = _model(1, jcfg, tcfg)
    x, con, emo = _x(8, B, 6, 12), _x(9, B, 8), _x(10, B, 8)
    tt = np.array([0, 17, 400, 999])
    for conds in ((con, emo), (con, None), (None, None)):
        ref = apply(v, x, tt, *conds)
        with torch.no_grad():
            out = port(t(x), t(tt), *(None if c is None else t(c) for c in conds))
        assert out.dtype == torch.float32 and out.shape == (B, 6, 12)
        tol = 1e-5 if dtype == "float32" else 3e-2 * float(np.abs(ref).max())
        assert max_err(out, ref) <= tol


@pytest.mark.parametrize("history,steps", [(4, 2), (4, 6), (10, 9)])
def test_loss_aware_update_matches_the_scan(history, steps):
    """Repeated timesteps in one batch keep the batch order, before and after
    the ring is full; the rows, counts and sampling weights are bit-equal."""
    rng = np.random.default_rng(history + steps)
    js, ps = jg.LossAwareState.create(5, history), tg.LossAwareState.create(5, history)
    crossed = shifted = False  # a row filled up within one batch; a full row shifted
    for i in range(steps):
        tt = rng.integers(0, 5, 12)
        tt[:4] = i % 5  # the same timestep four times at once
        losses = rng.normal(size=12).astype(np.float32)
        before = np.asarray(js.counts)
        js = jg.loss_aware_update(js, jnp.asarray(tt), jnp.asarray(losses))
        after = np.asarray(js.counts)
        crossed |= bool(np.any((before < history) & (after > history)))
        shifted |= bool(np.any((before >= history) & (after > before)))
        ps = tg.loss_aware_update(ps, t(tt), t(losses))
        np.testing.assert_array_equal(ps.loss_sq_history.numpy(), np.asarray(js.loss_sq_history))
        np.testing.assert_array_equal(ps.counts.numpy(), np.asarray(js.counts))
    assert crossed and shifted
    np.testing.assert_allclose(tg.loss_aware_weights(ps).numpy(),
                               np.asarray(jg.loss_aware_weights(js)), rtol=1e-6)


def test_sample_timesteps_draws_by_the_weights():
    state = tg.LossAwareState(torch.zeros(4, 2), torch.full((4,), 2))
    state = tg.loss_aware_update(state, torch.tensor([0, 1, 2, 3] * 2),
                                 torch.tensor([0.0, 0.0, 0.0, 10.0] * 2))
    g = torch.Generator().manual_seed(0)
    tt, w = tg.sample_timesteps(state, 4000, g)
    p = tg.loss_aware_weights(state)
    assert float((tt == 3).float().mean()) > 0.99 and p[3] > 0.99
    torch.testing.assert_close(w, 1.0 / (4 * p[tt]))


def _replayed_p_sample_noise(rng, shape, steps):
    k_init, key = jax.random.split(rng)
    rows = [jax.random.normal(k_init, shape, jnp.float32)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        rows.append(jax.random.normal(k, shape, jnp.float32))
    return np.stack([np.asarray(r) for r in rows])


@pytest.mark.parametrize("predict", ["x0", "epsilon"])
def test_samplers_with_injected_noise(predict):
    """p_sample_loop (all 50 steps) and ddim_sample_loop (10 steps) at T = 50,
    fed the JAX samplers' own draws."""
    apply, v, port = _model(2)
    betas = jg.cosine_betas(50)
    jgd, tgd = jg.make_gaussian_diffusion(betas), tg.make_gaussian_diffusion(betas)
    con, emo = _x(11, B, 8), _x(12, B, 8)
    shape = (B, 6, 12)

    def jfn(x, s):
        return apply(v, x, s, con, emo)

    def tfn(x, s):
        return port(x, s, t(con), t(emo))

    rng = jax.random.key(3)
    ref = jg.p_sample_loop(jgd, jfn, rng, shape, predict)
    with torch.no_grad():
        out = tg.p_sample_loop(tgd, tfn, shape, noise=t(_replayed_p_sample_noise(rng, shape, 50)),
                               predict=predict)
    assert max_err(out, ref) <= 1e-5 * max(1.0, float(np.abs(ref).max()))
    ref = jg.ddim_sample_loop(jgd, jfn, rng, shape, 10, predict)
    with torch.no_grad():
        out = tg.ddim_sample_loop(tgd, tfn, shape, 10,
                                  noise=t(jax.random.normal(rng, shape, jnp.float32)),
                                  predict=predict)
    assert max_err(out, ref) <= 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("loss_aware", [True, False])
def test_three_train_steps_with_jax_draws(loss_aware):
    """Three steps at dropout 0 fed the JAX step's draws (its split,
    sample_timesteps or randint, and normal calls replayed): the logs, every
    parameter and the sampler state; then (once) sample_fn at T = 50."""
    cfg_j = jtrain.RawTrainConfig(num_timesteps=50, loss_aware=loss_aware)
    cfg_t = ttrain.RawTrainConfig(num_timesteps=50, loss_aware=loss_aware)
    # jtrain.init_state with the random parameters (its flax init traced
    # only for the shapes)
    params = random_variables(_jax_model(JCFG)[1]["params"], 3, scale=0.2)
    jparams = jax.tree.map(jnp.asarray, params)
    state = jtrain.RawTrainState(jparams, optax.adamw(cfg_j.learning_rate).init(jparams),
                                 jg.LossAwareState.create(50), jnp.zeros((), jnp.int32))
    port = ttrain.init_state(0, TCFG, cfg_t, device="cpu")
    load(port.model, "diffusion", params)
    jstep, jsample = jtrain.make_train_step(JCFG, cfg_j)
    tstep, tsample = ttrain.make_train_step(TCFG, cfg_t)
    batch = {"motion": _x(13, 8, 6, 12, scale=0.3), "con": _x(14, 8, 8), "emo": _x(15, 8, 8)}
    sample_timesteps = jax.jit(jg.sample_timesteps, static_argnums=2)
    for i in range(3):
        rng = jax.random.key(100 + i)
        r_t, r_loss = jax.random.split(rng)
        if loss_aware:
            tt, _ = sample_timesteps(r_t, state.sampler_state, 8)
        else:
            tt = jax.random.randint(r_t, (8,), 0, 50)
        noise = jax.random.normal(r_loss, (8, 6, 12), jnp.float32)
        state, jlogs = jstep(state, jax.tree.map(jnp.asarray, batch), rng)
        logs = tstep(port, {k: t(x) for k, x in batch.items()},
                     draw=ttrain.RawStepDraw(t(np.asarray(tt)).long(), t(np.asarray(noise))))
        for k in ("loss", "loss_unweighted"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-5, err_msg=k)
    assert port.step == 3
    want = load(trd.RawPoseDenoiser(TCFG), "diffusion", jax.tree.map(np.asarray, state.params))
    got = dict(port.model.named_parameters())
    d = W["latent_dim"]
    for name, p in want.named_parameters():
        mine, ref = got[name].detach().numpy(), p.detach().numpy()
        if name.endswith("in_proj_bias"):
            # the key bias: zero gradient in exact arithmetic (a softmax row
            # is shift-invariant), so Adam moves it by +-lr per step on the
            # sign of each package's rounding noise
            assert max_err(mine[d:2 * d], ref[d:2 * d]) <= 3 * 2 * 1e-4, name
            mine, ref = np.delete(mine, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        assert max_err(mine, ref) <= 1e-6, name
    np.testing.assert_array_equal(port.sampler_state.counts.numpy(),
                                  np.asarray(state.sampler_state.counts))
    np.testing.assert_allclose(port.sampler_state.loss_sq_history.numpy(),
                               np.asarray(state.sampler_state.loss_sq_history), rtol=1e-5)
    if not loss_aware:
        return  # sample_fn does not depend on the timestep sampler
    cond = {"con": batch["con"][:2], "emo": batch["emo"][:2]}
    rng = jax.random.key(5)
    ref = jsample(state.params, rng, jax.tree.map(jnp.asarray, cond))
    out = tsample(port.model, {k: t(x) for k, x in cond.items()},
                  noise=t(_replayed_p_sample_noise(rng, (2, 6, 12), 50)))
    assert out.shape == (2, 6, 12) and max_err(out, ref) <= 1e-5 * max(1.0, float(np.abs(ref).max()))


def test_train_step_draws_from_its_generator():
    """Without injected draws the step draws timesteps and noise from the
    generator: two runs from one seed are identical, and the sampler state
    counts every sample."""
    results = []
    for _ in range(2):
        port = ttrain.init_state(0, TCFG, ttrain.RawTrainConfig(num_timesteps=50),
                                 device="cpu")
        step, _ = ttrain.make_train_step(TCFG, ttrain.RawTrainConfig(num_timesteps=50))
        g = torch.Generator().manual_seed(1)
        batch = {"motion": t(_x(16, B, 6, 12)), "con": t(_x(17, B, 8)), "emo": t(_x(18, B, 8))}
        logs = [float(step(port, batch, g)["loss"]) for _ in range(2)]
        results.append((logs, port.sampler_state.counts.clone()))
    assert results[0][0] == results[1][0] and all(np.isfinite(results[0][0]))
    assert int(results[0][1].sum()) == 2 * B and torch.equal(results[0][1], results[1][1])


def test_init_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.init_state(0, TCFG)
