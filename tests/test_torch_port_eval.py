"""The port's evaluation slice (``eval/metrics.py``, ``eval/embedder.py``,
``eval/runner.py``) against the JAX package (CPU, float32).

Same numpy-seeded inputs through both packages. Random draws that decide a
value are injected: diversity's pairs are JAX's ``jax.random`` draws, the
initial DDIM latents of ``evaluate_cache`` one numpy array on both sides.
Tolerances, float32 on both sides:

  * FGD: 1e-5 of tr C1 + tr C2 (two eigensolvers agree in the trace, not in
    the last bits of a small difference of large terms); 1e-4 of it where a
    covariance is rank-deficient (N <= D, as in the eval: 100 windows of 128
    features), whose near-zero eigenvalues enter through their square roots;
  * the other tensor metrics and the embedder: 1e-5 relative (1e-6 absolute
    where the value is near zero), the probes 1e-4 (a solve of a ridge
    system; the port's cross-fit solves in float64, JAX's in float32, held
    where the system is well posed, N > D);
  * the host-side detectors (onset envelope, peak picking, motion beats,
    beat alignment) are numpy copies: equal. Audio beats are held equal on
    inputs whose onsets clear the picker's threshold (bursts in silence):
    the two fbanks differ by up to 2.1e-4 in rare low-energy bins;
  * the eval report through both pipelines: every numeric key within 1e-3
    relative (FGD: 1e-3 of the covariance traces), the R-precision counts
    and every label equal.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.core import smplx as jsmplx
from amuse_tpu.eval import embedder as jemb
from amuse_tpu.eval import metrics as JM
from amuse_tpu.eval import runner as jrunner
from amuse_tpu_torch.core import smplx as tsmplx
from amuse_tpu_torch.eval import embedder as temb
from amuse_tpu_torch.eval import metrics as TM
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.eval import runner as trunner
from tests.torch_port_pipes import make_pipes

RTOL = 1e-5
PROBE_TOL = 1e-4
FGD_RANK_DEFICIENT_RTOL = 1e-4
REPORT_RTOL = 1e-3
ECFG = dict(in_dim=333, window=12, channels=(16, 8), latent_dim=8)


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def jax_pairs(n: int, seed: int = 0, num_pairs: int = 200):
    """The pairs ``amuse_tpu.eval.metrics.diversity`` draws."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    i = jax.random.randint(k1, (num_pairs,), 0, n)
    j = (i + jax.random.randint(k2, (num_pairs,), 1, n)) % n
    return np.asarray(i), np.asarray(j)


def flat_jax_params(params) -> dict:
    """A flax parameter tree -> the npz format's flat ``"enc16/kernel"`` keys."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.array(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def bursts(seed: int, samples: int = 32000, every: int = 5600) -> np.ndarray:
    """Silence with loud 40 ms bursts: every onset far above the threshold
    (a noise floor would add onsets at the threshold's edge)."""
    rng = np.random.default_rng(seed)
    wave = np.zeros(samples)
    for s in range(800 + 97 * seed % 1000, samples - 640, every):
        wave[s:s + 640] += 0.3 * rng.normal(size=640)
    return wave.astype(np.float32)


class TestMetrics:
    @pytest.mark.parametrize("n", [1, 6, 40])
    def test_fgd(self, n):
        real, gen = _np(n, n, 8), _np(n + 1, n + 3, 8, scale=1.3) + 0.2
        want = float(JM.fgd(jnp.asarray(real), jnp.asarray(gen)))
        got = float(TM.fgd(_t(real), _t(gen)))
        scale = np.trace(np.cov(real.T, ddof=1)) if n > 1 else 0.0
        scale += np.trace(np.cov(gen.T, ddof=1))
        tol = RTOL if n > 8 else FGD_RANK_DEFICIENT_RTOL
        assert abs(got - want) <= tol * scale, (got, want, scale)
        mu1, mu2, c1, c2 = (_np(9, 8), _np(10, 8), _np(11, 8, 8), _np(12, 8, 8))
        c1, c2 = c1 @ c1.T, c2 @ c2.T
        want = float(JM.gaussian_frechet_distance(*map(jnp.asarray, (mu1, c1, mu2, c2))))
        got = float(TM.gaussian_frechet_distance(*map(_t, (mu1, c1, mu2, c2))))
        assert abs(got - want) <= RTOL * (np.trace(c1) + np.trace(c2))

    def test_diversity_ape_ave(self):
        feats = _np(0, 30, 16)
        pairs = jax_pairs(30, seed=3)
        want = float(JM.diversity(jnp.asarray(feats), seed=3))
        assert float(TM.diversity(_t(feats), pairs=pairs)) == pytest.approx(want, rel=RTOL)
        # the port's own draw: distinct pairs, the same on every call
        i, j = TM.diversity_pairs(30, seed=3)
        assert (i != j).all() and torch.equal(i, TM.diversity_pairs(30, seed=3)[0])
        for n in (0, 1):  # fewer than two features: 0
            assert float(TM.diversity(_t(feats[:n]), pairs=jax_pairs(2))) == 0.0
            assert float(JM.diversity(jnp.asarray(feats[:n]))) == 0.0
        gt, pred = _np(1, 2, 12, 5, 3), _np(2, 2, 12, 5, 3)
        for jf, tf in ((JM.ape, TM.ape), (JM.ave, TM.ave)):
            assert float(tf(_t(gt), _t(pred))) == pytest.approx(
                float(jf(jnp.asarray(gt), jnp.asarray(pred))), rel=RTOL)

    def test_beat_detectors_are_the_same_numpy(self):
        mel = _np(3, 200, 16, scale=3.0)
        np.testing.assert_array_equal(TM.onset_envelope(mel), JM.onset_envelope(mel))
        env = JM.onset_envelope(mel)
        np.testing.assert_array_equal(TM.pick_peaks(env), JM.pick_peaks(env))
        assert TM.pick_peaks(np.zeros(0)).size == 0
        joints = np.cumsum(_np(4, 90, 5, 3, scale=0.1), axis=0)
        mb = TM.motion_beats_from_joints(joints)
        np.testing.assert_array_equal(mb, JM.motion_beats_from_joints(joints))
        assert TM.motion_beats_from_joints(joints[:2]).size == 0
        ab = np.array([0.1, 0.9, 1.7, 2.5])
        assert TM.beat_alignment(mb, ab) == JM.beat_alignment(mb, ab)
        assert TM.beat_alignment(mb, np.zeros(0)) == 0.0

    @pytest.mark.parametrize("seed", [0, 1])
    def test_audio_beats_match_jax_exactly(self, seed):
        """Beat times held equal, frame for frame, on onsets that clear the
        threshold; a 2-D input reads its first row in both."""
        wave = bursts(seed)
        want = JM.audio_beats_from_waveform(wave)
        got = TM.audio_beats_from_waveform(wave)
        assert want.size >= 4
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TM.audio_beats_from_waveform(np.stack([wave, wave * 0])),
                                      want)

    def test_probes_and_distances(self):
        cond, motion = _np(5, 24, 10), _np(6, 24, 6)
        np.testing.assert_allclose(
            TM.euclidean_distance_matrix(_t(cond[:5]), _t(cond[5:9])).numpy(),
            np.asarray(JM.euclidean_distance_matrix(jnp.asarray(cond[:5]),
                                                    jnp.asarray(cond[5:9]))),
            rtol=RTOL, atol=1e-6)
        w = TM.fit_linear_probe(_t(cond), _t(motion))
        jw = JM.fit_linear_probe(jnp.asarray(cond), jnp.asarray(motion))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=PROBE_TOL, atol=PROBE_TOL)
        np.testing.assert_allclose(TM.apply_linear_probe(w, _t(cond)).numpy(),
                                   np.asarray(JM.apply_linear_probe(jw, jnp.asarray(cond))),
                                   rtol=PROBE_TOL, atol=PROBE_TOL)
        np.testing.assert_allclose(
            TM.cross_fit_linear_probe(_t(cond), _t(motion), seed=4).numpy(),
            np.asarray(JM.cross_fit_linear_probe(jnp.asarray(cond), jnp.asarray(motion),
                                                 seed=4)),
            rtol=PROBE_TOL, atol=PROBE_TOL)

    @pytest.mark.parametrize("case", ["random", "collapsed"])
    def test_r_precision_suite(self, case):
        """Equal counts and matching scores within RTOL; a mode-collapsed
        generator (every embedding equal: all ties) reads chance through the
        half-counted ties, not a perfect top-1."""
        cond = _np(7, 70, 6)
        motion = cond + _np(8, 70, 6, scale=0.5) if case == "random" else np.ones((70, 6),
                                                                                np.float32)
        want = JM.r_precision_suite(jnp.asarray(cond), jnp.asarray(motion), r_size=32, seed=2)
        got = TM.r_precision_suite(_t(cond), _t(motion), r_size=32, seed=2)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=RTOL), k
        if case == "collapsed":
            assert got["r_precision_top_1"] < 0.1
        with pytest.raises(ValueError, match="r_size"):
            TM.r_precision_suite(_t(cond[:8]), _t(motion[:8]), r_size=32)


class TestEmbedder:
    @pytest.fixture(scope="class")
    def jparams(self):
        return jemb.init_params(jax.random.key(0), jemb.EmbedderConfig(**ECFG))

    def test_embedding_and_reconstruction_match_flax(self, jparams):
        x = _np(0, 3, 12, 333)
        jz, jrec = jemb.MotionEmbedder(jemb.EmbedderConfig(**ECFG)).apply(
            {"params": jparams}, jnp.asarray(x), True)
        model = temb.make_model(flat_jax_params(jparams), temb.EmbedderConfig(**ECFG), "cpu")
        with torch.no_grad():
            z, rec = model(_t(x))
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), rtol=RTOL, atol=1e-6)
        np.testing.assert_array_equal(temb.embed(model, _t(x)).numpy(), z.numpy())

    def test_init_follows_flax_initialisers(self, jparams):
        """The same shapes and keys; kernels lecun-normal (truncated at two
        deviations: std 1/sqrt(fan_in), none beyond 2/0.8796 of it), zero biases."""
        flat = flat_jax_params(jparams)
        mine = temb.init_params(0, temb.EmbedderConfig(**ECFG))
        assert mine.keys() == flat.keys()
        for k, v in mine.items():
            assert tuple(v.shape) == flat[k].shape, k
            if k.endswith("bias"):
                assert not v.any(), k
                continue
            std = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
            assert v.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7, k
            if v.numel() > 1000:
                assert float(v.std()) == pytest.approx(std, rel=0.05), k
        with pytest.raises(ValueError, match="distinct"):
            temb.MotionEmbedder(temb.EmbedderConfig(channels=(8, 8)))

    def test_three_adam_steps_match_optax(self, jparams):
        cfg = jemb.EmbedderConfig(**ECFG)
        step, opt = jemb.make_train_step(cfg, 1e-2)
        params, opt_state = jparams, opt.init(jparams)
        model = temb.make_model(flat_jax_params(jparams), temb.EmbedderConfig(**ECFG), "cpu")
        tstep, _ = temb.make_train_step(model, 1e-2)
        for i in range(3):
            batch = _np(10 + i, 4, 12, 333, scale=0.5)
            params, opt_state, loss = step(params, opt_state, jnp.asarray(batch))
            assert float(tstep(_t(batch))) == pytest.approx(float(loss), rel=RTOL)
        got, want = temb.params_of(model), flat_jax_params(params)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4, atol=1e-5, err_msg=k)

    def test_committed_weights_load_in_both(self):
        jp = temb.DEFAULT_WEIGHTS.parent.parent.parent.parent / "amuse_tpu" / "eval" / \
            "weights" / "motion_embedder_synthetic.npz"
        assert jp == jemb.DEFAULT_WEIGHTS
        digest = [hashlib.sha256(p.read_bytes()).hexdigest()
                  for p in (temb.DEFAULT_WEIGHTS, jemb.DEFAULT_WEIGHTS)]
        assert digest[0] == digest[1]
        jparams, jcfg, jprov = jemb.load(jemb.DEFAULT_WEIGHTS)
        params, cfg, prov = temb.load(temb.DEFAULT_WEIGHTS)
        assert (cfg.in_dim, cfg.window, cfg.channels, cfg.latent_dim) == (
            jcfg.in_dim, jcfg.window, jcfg.channels, jcfg.latent_dim) and prov == jprov
        x = _np(1, 2, cfg.window, cfg.in_dim, scale=0.3)
        want = np.asarray(jemb.embed(jparams, jcfg, jnp.asarray(x)))
        got = temb.embed(temb.make_model(params, cfg, "cpu"), _t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)

    def test_files_cross_load(self, jparams, tmp_path):
        """A file saved by the port loads in JAX, and the reverse, to the
        same parameters, config and provenance."""
        cfg = temb.EmbedderConfig(**ECFG)
        mine = temb.init_params(5, cfg)
        temb.save(tmp_path / "port.npz", mine, cfg, "port provenance")
        p, c, prov = jemb.load(tmp_path / "port.npz")
        assert c == jemb.EmbedderConfig(**ECFG) and prov == "port provenance"
        for k, v in flat_jax_params(p).items():
            np.testing.assert_array_equal(v, mine[k].numpy(), err_msg=k)
        jemb.save(tmp_path / "jax.npz", jparams, jemb.EmbedderConfig(**ECFG), "jax provenance")
        p, c, prov = temb.load(tmp_path / "jax.npz")
        assert c == cfg and prov == "jax provenance"
        for k, v in flat_jax_params(jparams).items():
            np.testing.assert_array_equal(p[k].numpy(), v, err_msg=k)


class FakeCache:
    """n windows of 12 frames with conditioning, actor ids and 2 s of audio."""

    def __init__(self, n: int = 10, cond: int = 8, window: int = 12):
        rng = np.random.default_rng(0)
        self.items = [{"motion": (0.1 * rng.normal(size=(window, 168))).astype(np.float32),
                       "con": rng.normal(size=cond).astype(np.float32),
                       "emo": rng.normal(size=cond).astype(np.float32),
                       "sty": rng.normal(size=cond).astype(np.float32),
                       "actor_id": np.int32(i % 3), "audio": bursts(i)} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class JaxLatents:
    """The JAX pipeline whose DDIM latents are batch slices of one array."""

    def __init__(self, pipe, x0):
        self.pipe, self.x0, self.start = pipe, x0, 0

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def generate_latents(self, rng, con, emo=None, sty=None):
        x0 = self.x0[self.start:self.start + con.shape[0]]
        self.start += con.shape[0]
        return self.pipe.generate_latents(None, con, emo, sty, initial_latents=jnp.asarray(x0))


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(0)


@pytest.fixture(scope="module")
def reports(pipes):
    """{space: (JAX's report, the port's)} of 10 windows at batch 4 (a tail
    batch of 2), the embedder, the beats and the probes, both packages fed
    the same initial latents and diversity pairs."""
    jpipe, port = pipes
    cache = FakeCache()
    x0 = _np(3, len(cache), 1, 16)
    jcfg = jemb.EmbedderConfig(**ECFG)
    jparams = jemb.init_params(jax.random.key(1), jcfg)
    tparams = {k: torch.from_numpy(v) for k, v in flat_jax_params(jparams).items()}
    rigs = {"rotation": (None, None),
            "position": (jsmplx.make_test_model(num_vertices=32, num_joints=55, num_betas=8,
                                                parents=jsmplx.SMPLX_PARENTS),
                         tsmplx.make_test_model(num_vertices=32, num_joints=55, num_betas=8,
                                                parents=tsmplx.SMPLX_PARENTS))}
    plain, out = TM.diversity, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "diversity", lambda feats, seed=0: plain(
            feats, pairs=jax_pairs(feats.shape[0], seed)))
        for space, (jrig, trig) in rigs.items():
            want = jrunner.evaluate_cache(JaxLatents(jpipe, x0), cache, batch_size=4, seed=2,
                                          smplx_model=jrig, embedder=(jparams, jcfg, "prov"))
            got = trunner.evaluate_cache(port, cache, batch_size=4, seed=2, smplx_model=trig,
                                         embedder=(tparams, temb.EmbedderConfig(**ECFG), "prov"),
                                         initial_latents=_t(x0))
            out[space] = (want, got)
    return out


@pytest.mark.parametrize("space", ["rotation", "position"])
def test_evaluate_cache_matches_jax(reports, space):
    """Every key of the report agrees with JAX's."""
    want, got = reports[space]
    assert got.keys() == want.keys() and got["metric_space"] == space
    json.dumps(got)
    assert got["num_windows"] == 10.0 and "beat_align_gen" in got
    for k, v in want.items():
        if isinstance(v, str) or k.startswith("r_precision_top"):
            assert got[k] == v, k
        elif k.startswith("fgd"):
            assert abs(got[k] - v) <= REPORT_RTOL * max(abs(v), 1.0), (k, got[k], v)
        else:
            assert got[k] == pytest.approx(v, rel=REPORT_RTOL, abs=1e-6), k


def test_cli_eval_gesture_report_keys_match_jax(reports, tmp_path, capsys):
    """--fn eval_gesture with --device cpu over a window cache of 8 windows
    (the cache layout, written here), an SMPL-X npz of the 55-joint tree and
    the committed embedder: eval_results.json has the keys of JAX's report,
    which JAX's task_eval_gesture writes as evaluate_cache returns it."""
    rng = np.random.default_rng(0)
    shard = tmp_path / "cache" / "shard_00000"
    shard.mkdir(parents=True)
    fields = {"motion": (0.2 * rng.normal(size=(8, 300, 168))).astype(np.float32),
              "actor_id": np.arange(8, dtype=np.int32) % 3,
              "emo_label": np.zeros(8, np.int32),
              "audio": np.stack([bursts(i, samples=160000) for i in range(8)]),
              **{k: rng.normal(size=(8, 12)).astype(np.float32) for k in ("con", "emo", "sty")}}
    for k, v in fields.items():
        np.save(shard / f"{k}.npy", v)
    (tmp_path / "cache" / "manifest.json").write_text(json.dumps(
        {"num_windows": 8, "shards": [shard.name], "fields": list(fields)}))
    rig = tsmplx.make_test_model(num_vertices=16, num_joints=55, num_betas=10,
                                 parents=tsmplx.SMPLX_PARENTS)
    (tmp_path / "smplx").mkdir()
    np.savez(tmp_path / "smplx" / "SMPLX_NEUTRAL.npz", v_template=rig.v_template.numpy(),
             shapedirs=rig.shapedirs.numpy(), posedirs=rig.posedirs.numpy().T.reshape(16, 3, -1),
             J_regressor=rig.j_regressor.numpy(), weights=rig.lbs_weights.numpy(),
             kintree_table=np.stack([rig.parents, np.arange(55)]))
    cfg = {"audio": {"ast_embed_dim": 16, "ast_depth": 1, "ast_heads": 2, "ast_feature_dim": 12},
           "gesture": {"latent_dim": 16, "ff_size": 32, "num_layers": 3, "num_heads": 2,
                       "cond_dim": 12, "num_inference_steps": 3, "batch_size": 4},
           "data": {"cache_dir": str(tmp_path / "cache"),
                    "smplx_model_dir": str(tmp_path / "smplx")},
           "dtype": "float32", "out_dir": str(tmp_path / "runs")}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    cli.main(["--fn", "eval_gesture", "--cfg", str(tmp_path / "cfg.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "position space" in out and "motion_embedder_synthetic.npz" in out
    (path,) = (tmp_path / "runs").glob("*/eval_results.json")
    got = json.loads(path.read_text())
    assert got.keys() == reports["position"][0].keys()
    assert got["metric_space"] == "position" and got["num_windows"] == 8.0
    assert got["r_precision_probe"] == reports["position"][0]["r_precision_probe"]
    assert got["fgd_embedder_provenance"] == temb.load(temb.DEFAULT_WEIGHTS)[2]
    assert all(np.isfinite(v) for v in got.values() if isinstance(v, float))


def test_evaluate_cache_draws_its_own_latents(pipes):
    """Without injected latents the port draws each batch's from a CPU
    generator of (seed, batch start): reruns agree, another seed differs."""
    _, port = pipes
    cache = FakeCache(n=5)
    a = trunner.evaluate_cache(port, cache, batch_size=4, seed=0)
    b = trunner.evaluate_cache(port, cache, batch_size=4, seed=0)
    c = trunner.evaluate_cache(port, cache, batch_size=4, seed=1)
    assert a == b and a["fgd"] != c["fgd"] and "matching_score_real" not in a
    assert torch.equal(trunner.batch_latents(0, 4, (1, 1, 16)),
                       trunner.batch_latents(0, 4, (1, 1, 16)))
    assert trunner.evaluate_cache(port, [], batch_size=4)["num_windows"] == 0.0
