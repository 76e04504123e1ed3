"""The port's host-side data utilities against the JAX package, on the CPU.

``amuse_tpu_torch.data.{bvh, motion_features, pymo_pipeline, textgrid,
facial, corpus}``, ``utils.profiling`` and ``cluster.sweep`` against their
``amuse_tpu`` counterparts, on inputs made with numpy from a seed. Bounds:
the BVH axis-angles (float32 in both packages) through their rotation
matrices atol 1e-5, and as vectors where the angle is below pi - 1e-2 (at pi
the axis' sign is a rounding choice); everything computed in numpy and scipy
by both packages is held equal (atol 1e-12 where float64 sums run in
another order).

The port's span recorder (``utils.profiling.recording``, ``span``) is
tested on its own, and over the spans that a tiny CPU pipeline and stage-1
step record.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import tests.test_utils_extra as jax_extra_tests
from amuse_tpu.cluster import sweep as jsweep
from amuse_tpu.data import bvh as jbvh
from amuse_tpu.data import corpus as jcorpus
from amuse_tpu.data import facial as jfacial
from amuse_tpu.data import motion_features as jmf
from amuse_tpu.data import pymo_pipeline as jpymo
from amuse_tpu.data import textgrid as jtg
from amuse_tpu.utils import profiling as jprof
from amuse_tpu_torch.cluster import sweep
from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
from amuse_tpu_torch.data import bvh, corpus, facial, motion_features, pymo_pipeline, textgrid
from amuse_tpu_torch.utils import profiling

AA_ATOL = 1e-5


def make_rig(path, joints: int, order: str, frames: int, seed: int, root: str = "pelvis",
             frame_time: float = 0.033333, position_only=()) -> object:
    """A chain skeleton written as BVH: the root with position and rotation
    channels, each other joint with rotation channels in ``order`` (or
    position channels only, for the indices in ``position_only``), an end
    site; Euler angles uniform in [-180, 180) degrees. -> the port's parse."""
    rng = np.random.default_rng(seed)
    rot = [f"{a}rotation" for a in order]
    pos = ["Xposition", "Yposition", "Zposition"]
    js = [bvh.BvhJoint(root, -1, np.zeros(3), pos + rot)]
    for i in range(1, joints):
        js.append(bvh.BvhJoint(f"j{i}", i - 1, rng.normal(scale=10, size=3),
                               list(pos if i in position_only else rot)))
    js.append(bvh.BvhJoint(f"j{joints - 1}_end", joints - 1, np.array([0.0, 5.0, 0.0]), [],
                           is_end_site=True))
    data = rng.uniform(-180, 180, size=(frames, sum(len(j.channels) for j in js)))
    data[:, :3] = rng.normal(scale=50, size=(frames, 3))
    bvh.write_bvh(path, bvh.BvhData(js, data, frame_time))
    return bvh.parse_bvh(path)


def raw_beat_skeleton(path, frames: int = 4) -> None:
    """A raw 75-joint BEAT-style capture rooted at Hips (no SMPL-X rig)."""
    make_rig(path, 75, "ZXY", frames, seed=5, root="Hips")


def assert_poses_close(got, want, atol=AA_ATOL):
    """Axis-angles through their rotation matrices, and as vectors away from pi."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mats = [axis_angle_to_matrix(torch.from_numpy(x)).numpy() for x in (got, want)]
    np.testing.assert_allclose(mats[0], mats[1], atol=atol, rtol=0)
    clear = np.linalg.norm(want, axis=-1) < np.pi - 1e-2
    np.testing.assert_allclose(got[clear], want[clear], atol=atol, rtol=0)


def _joints(data):
    return [(j.name, j.parent, tuple(j.offset), tuple(j.channels), j.is_end_site)
            for j in data.joints]


# --------------------------------------------------------------------- data/bvh.py


@pytest.mark.parametrize("order", ["ZXY", "ZYX"])
def test_bvh_to_axis_angle_matches_jax(tmp_path, order):
    """A 6-joint rig with a position-only joint (its pose is exactly zero in
    both), 40 frames of random Euler angles: parse, poses, trans, names."""
    path = tmp_path / "a.bvh"
    mine = make_rig(path, 6, order, 40, seed=1, position_only=(3,))
    ref = jbvh.parse_bvh(path)
    assert _joints(mine) == _joints(ref) and mine.frame_time == ref.frame_time
    np.testing.assert_array_equal(mine.frames, ref.frames)
    poses, trans, names = bvh.bvh_to_axis_angle(mine, "cpu")
    jposes, jtrans, jnames = jbvh.bvh_to_axis_angle(ref)
    assert poses.dtype == np.float32 and poses.shape == jposes.shape == (40, 6, 3)
    assert names == jnames
    np.testing.assert_array_equal(trans, jtrans)
    assert_poses_close(poses, jposes)
    assert np.all(poses[:, 3] == 0) and np.all(jposes[:, 3] == 0)
    # and the poses are the rotations the Euler angles describe (float32)
    mats, _, _ = bvh.joint_matrices(mine)
    rebuilt = axis_angle_to_matrix(torch.from_numpy(poses.astype(np.float64))).numpy()
    np.testing.assert_allclose(rebuilt, mats, atol=AA_ATOL)


@pytest.mark.parametrize("order", ["ZXY", "ZYX", "XYZ", "YZX", "XZY", "YXZ"])
def test_euler_to_matrix_matches_jax(order):
    ang = np.random.default_rng(2).uniform(-180, 180, size=(16, 3))
    np.testing.assert_array_equal(bvh._euler_to_matrix(ang, order),
                                  jbvh._euler_to_matrix(ang, order))


def test_retargeted_npz_matches_jax(tmp_path):
    """The 55-joint SMPL-X rig in ZYX with the truncated 30 fps frame time:
    the reorder map, the zeroed jaw and eye slots, the recentred metres, the
    actor's gender and betas, and mocap_frame_rate 31 in both packages."""
    path = tmp_path / "rig.bvh"
    make_rig(path, 55, "ZYX", 20, seed=3)
    out = bvh.convert_retargeted_bvh_to_npz(path, tmp_path / "port.npz", subject="scott",
                                            device="cpu")
    jout = jbvh.convert_retargeted_bvh_to_npz(path, tmp_path / "jax.npz", subject="scott")
    d, jd = np.load(out), np.load(jout)
    assert set(d.files) == set(jd.files) == {"poses", "trans", "gender", "mocap_frame_rate",
                                             "betas"}
    assert float(d["mocap_frame_rate"]) == float(jd["mocap_frame_rate"]) == 31.0
    assert str(d["gender"]) == str(jd["gender"]) == "male" and d["gender"].dtype == "<U7"
    np.testing.assert_array_equal(d["betas"], jd["betas"])
    np.testing.assert_array_equal(d["trans"], jd["trans"])
    assert d["poses"].dtype == jd["poses"].dtype == np.float64
    assert_poses_close(d["poses"], jd["poses"])
    assert np.all(d["poses"][:, 22:25] == 0)
    np.testing.assert_array_equal(bvh.BEAT55_BVH_TO_SMPLX_ORDER, jbvh.BEAT55_BVH_TO_SMPLX_ORDER)
    with pytest.raises(ValueError, match="retarget"):
        bvh.retargeted_bvh_to_smplx(make_rig(tmp_path / "s.bvh", 4, "ZXY", 2, seed=4), "cpu")


@pytest.mark.parametrize("root,want", [("Hips", False), ("pelvis", True),
                                       ("Armature:Pelvis", True)])
def test_looks_like_smplx_rig_matches_jax(tmp_path, root, want):
    """A raw 75-joint BEAT skeleton passes the joint count but is no SMPL-X
    rig; a (namespaced) pelvis root is."""
    path = tmp_path / "a.bvh"
    make_rig(path, 75, "ZXY", 2, seed=5, root=root)
    assert bvh.looks_like_smplx_rig(bvh.parse_bvh(path)) is want
    assert jbvh.looks_like_smplx_rig(jbvh.parse_bvh(path)) is want


def test_write_bvh_round_trip_matches_jax(tmp_path):
    """Parse -> write -> parse keeps the hierarchy and the frames, and the
    written text is the JAX package's byte for byte; a ``Frames:`` count
    below the rows present truncates in both."""
    path = tmp_path / "a.bvh"
    mine = make_rig(path, 5, "ZXY", 6, seed=6)
    out = bvh.write_bvh(tmp_path / "b.bvh", mine)
    jout = jbvh.write_bvh(tmp_path / "c.bvh", jbvh.parse_bvh(path))
    assert out.read_text() == jout.read_text() == path.read_text()
    again = bvh.parse_bvh(out)
    assert _joints(again) == _joints(mine)
    np.testing.assert_array_equal(again.frames, mine.frames)
    short = tmp_path / "short.bvh"
    short.write_text(path.read_text().replace("Frames: 6", "Frames: 4"))
    assert bvh.parse_bvh(short).num_frames == jbvh.parse_bvh(short).num_frames == 4


# ------------------------------------------------------- data/motion_features.py


def test_forward_kinematics_and_features_match_jax(tmp_path):
    path = tmp_path / "a.bvh"
    mine = make_rig(path, 5, "ZXY", 12, seed=7)
    pos = motion_features.forward_kinematics(mine)
    jpos = jmf.forward_kinematics(jbvh.parse_bvh(path))
    assert pos.shape == (12, 6, 3)
    np.testing.assert_allclose(pos, jpos, atol=1e-12, rtol=0)
    pipe, jpipe = motion_features.MotionFeaturePipeline().fit(pos), jmf.MotionFeaturePipeline().fit(pos)
    feats = pipe.transform(pos)
    np.testing.assert_array_equal(feats, jpipe.transform(pos))
    np.testing.assert_array_equal(pipe.inverse(feats), jpipe.inverse(feats))
    pipe.save(tmp_path / "stats.npz")  # each package reads the other's statistics
    np.testing.assert_array_equal(jmf.MotionFeaturePipeline.load(tmp_path / "stats.npz")
                                  .transform(pos), feats)


# --------------------------------------------------------- data/pymo_pipeline.py


def _pymo_bvh(fps: float, seed: int):
    """tests/test_pymo_pipeline.py's walking skeleton, as the port's BvhData."""
    from tests.test_pymo_pipeline import _make_bvh

    ref = _make_bvh(frames=16, fps=fps, seed=seed)
    mine = bvh.BvhData([bvh.BvhJoint(**dataclasses.asdict(j)) for j in ref.joints],
                       ref.frames.copy(), ref.frame_time)
    return mine, ref


@pytest.mark.parametrize("tag", ["v0", "v1", "v2", "v3", "v4", "v5"])
def test_pymo_options_match_jax(tag):
    for version in (f"pymo_dB_{tag}", f"pymo_dB_{tag}_fing"):
        assert (dataclasses.asdict(pymo_pipeline.options_for_version(version, 20))
                == dataclasses.asdict(jpymo.options_for_version(version, 20)))


@pytest.mark.parametrize("opts", [
    dict(root_transform="none"), dict(), dict(position_smoothing=5, rotation_smoothing=10),
    dict(keep_root_trans=True), dict(joints=("Spine",)), dict(tgt_fps=30, fps=60.0),
])
def test_pymo_pipeline_matches_jax(opts):
    """Features, their inverse on the fitted skeleton and the joints from
    them (feats_to_joints), for each option of the pipeline and a 60 -> 30
    fps downsample."""
    opts = dict(opts)
    mine, ref = _pymo_bvh(opts.pop("fps", 30.0), seed=1)
    pipe = pymo_pipeline.PymoPipeline(pymo_pipeline.PymoOptions(**opts))
    jpipe = jpymo.PymoPipeline(jpymo.PymoOptions(**opts))
    feats = pipe.fit_transform(mine)
    jfeats = jpipe.fit_transform(ref)
    assert pipe.joint_names == jpipe.joint_names and pipe.joint_orders == jpipe.joint_orders
    np.testing.assert_array_equal(feats, jfeats)
    back, jback = pipe.inverse(feats), jpipe.inverse(jfeats)
    np.testing.assert_array_equal(back.frames, jback.frames)
    assert back.frame_time == jback.frame_time
    np.testing.assert_array_equal(pymo_pipeline.feats_to_joints(pipe, feats),
                                  jpymo.feats_to_joints(jpipe, jfeats))


# ------------------------------------------------------------ data/textgrid.py


def test_textgrid_matches_jax(tmp_path):
    """tests/test_utils_extra.py's TextGrid, plus a second tier and a file
    without tiers."""
    sample = jax_extra_tests.TestTextGrid.SAMPLE
    two = sample.replace("size = 1", "size = 2") + sample[sample.index("    item [1]:"):].replace(
        "item [1]", "item [2]").replace('"words"', '"phones"').replace('"hello"', '"HH"')
    for name, text in (("one", sample), ("two", two), ("none", 'File type = "ooTextFile"\n')):
        p = tmp_path / f"{name}.TextGrid"
        p.write_text(text)
        tiers, jtiers = textgrid.parse_textgrid(p), jtg.parse_textgrid(p)
        assert ({k: dataclasses.astuple(v) for k, v in tiers.items()}
                == {k: dataclasses.astuple(v) for k, v in jtiers.items()})
        for tier in (None, "words", "phones", "missing"):
            kw = {} if tier is None else {"tier_name": tier}
            assert textgrid.word_onsets(tiers, **kw) == jtg.word_onsets(jtiers, **kw)
        for k in tiers:
            for t in (0.0, 0.7, 1.3, 2.5, 9.0):
                assert tiers[k].at(t) == jtiers[k].at(t)
            assert [dataclasses.astuple(w) for w in tiers[k].words()] == [
                dataclasses.astuple(w) for w in jtiers[k].words()]


# -------------------------------------------------------------- data/facial.py


@pytest.mark.parametrize("frames,dt", [(70, 1 / 60), (70, 1 / 120), (5, 1 / 60), (1, 1 / 60),
                                       (0, 1 / 60), (8, 0.0)])
def test_facial_matches_jax(frames, dt):
    """Decimation to 30 fps from the timestamps (the long, short and
    degenerate estimates), the lip/remaining split over a shuffled subset of
    names, the recombination and the standardisation."""
    rng = np.random.default_rng(frames)
    names = list(rng.permutation(facial.LIP_SYNC_FACS + facial.REMAINING_FACS)[:45])
    capture = {"names": names, "frames": [
        {"time": i * dt, "weights": rng.uniform(size=len(names)).tolist()}
        for i in range(frames)]}
    assert facial.facial_frame_rate(capture) == jfacial.facial_frame_rate(capture)
    got, want = facial.process_facial(capture), jfacial.process_facial(capture)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    lip, rem, _ = got
    np.testing.assert_array_equal(facial.combine_streams(lip, rem[::-1], names),
                                  jfacial.combine_streams(lip, rem[::-1], names))
    if frames > 1:
        z, m, s = facial.standardize(rem)
        jz, jm, js = jfacial.standardize(rem)
        for a, b in ((z, jz), (m, jm), (s, js)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(facial.standardize(z, m, s, forward=False)[0],
                                      jfacial.standardize(z, m, s, forward=False)[0])
    assert facial.COMBINED_FACS == jfacial.COMBINED_FACS


# -------------------------------------------------------------- data/corpus.py


def test_corpus_matches_jax():
    """The hashed embedding, the dialogue encoding (GPT-2 where its weights
    are cached locally in both, the hashed fallback otherwise) and every
    vendored take transcript."""
    for text in ("", "Hello there", "the quick brown fox the"):
        np.testing.assert_array_equal(corpus.hash_embedding(text, 32),
                                      jcorpus.hash_embedding(text, 32))
    np.testing.assert_array_equal(corpus.encode_dialogue_batch(["", "well I think so"], 24),
                                  jcorpus.encode_dialogue_batch(["", "well I think so"], 24))
    jcorpus.take_transcript("0_9_9")
    assert corpus.take_transcript("0_9_9") is not None
    for take in jcorpus._TRANSCRIPTS:
        assert corpus.take_transcript(take) == jcorpus.take_transcript(take)
    assert corpus.take_transcript("9_9_9") is None and corpus.encode_take_transcript("9_9_9") is None
    np.testing.assert_array_equal(corpus.encode_take_transcript("0_65_65", 16),
                                  jcorpus.encode_take_transcript("0_65_65", 16))


# --------------------------------------------------------- utils/profiling.py


def test_step_timer_matches_jax():
    """The same samples give the JAX timer's summary and report; phase()
    records one sample per block, raising blocks included."""
    rng = np.random.default_rng(8)
    timer, jtimer = profiling.StepTimer(), jprof.StepTimer()
    for name in ("step", "data", "eval"):
        for s in rng.exponential(0.01, size=int(rng.integers(1, 40))):
            timer.record(name, float(s))
            jtimer.record(name, float(s))
    assert timer.summary() == jtimer.summary()
    assert timer.report() == jtimer.report()
    with pytest.raises(RuntimeError):
        with timer.phase("fails"):
            raise RuntimeError
    with timer.phase("fails"):
        pass
    assert timer.summary()["fails"]["count"] == 2


def test_spans_nest_under_the_span_open_when_they_began():
    """Each phase records a span whose parent is the innermost span open
    when it began, in the order the spans began, ends after starts."""
    timer = profiling.StepTimer()
    with timer.phase("a"):
        with timer.phase("b"):
            with timer.phase("c"):
                pass
        with timer.phase("d"):
            pass
    with timer.phase("e"):
        pass
    assert [(s.name, s.parent) for s in timer.spans] == [
        ("a", -1), ("b", 0), ("c", 1), ("d", 0), ("e", -1)]
    for s in timer.spans:
        assert isinstance(s.start_ns, int) and s.start_ns <= s.end_ns
        if s.parent >= 0:
            outer = timer.spans[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
    assert timer.summary()["b"]["count"] == 1


def test_a_root_opens_a_request_its_children_share():
    """Children carry their root's request id; each new root opens the next."""
    with profiling.recording() as rec:
        for _ in range(3):
            with profiling.span("root"):
                with profiling.span("child"):
                    with profiling.span("grandchild"):
                        pass
                with profiling.span("child"):
                    pass
        with profiling.span("lone"):
            pass
    by_request = {}
    for s in rec.spans:
        by_request.setdefault(s.request, []).append(s.name)
    assert by_request == {0: ["root", "child", "grandchild", "child"],
                          1: ["root", "child", "grandchild", "child"],
                          2: ["root", "child", "grandchild", "child"], 3: ["lone"]}


def test_a_span_that_raises_is_recorded_and_counted():
    """The block's exception passes through; the span is closed, its parent
    is open again for the next span, and summary() counts it."""
    with profiling.recording() as rec:
        with profiling.span("outer"):
            with pytest.raises(ValueError):
                with profiling.span("fails"):
                    raise ValueError
            with profiling.span("after"):
                pass
    assert [(s.name, s.parent) for s in rec.spans] == [("outer", -1), ("fails", 0),
                                                     ("after", 0)]
    assert rec.spans[1].end_ns >= rec.spans[1].start_ns
    assert rec.summary()["fails"]["count"] == 1


def test_off_span_is_one_shared_object_that_calls_nothing():
    """With no recorder active (after a recording block too), span() and
    request_span() return the same object every call, record nothing, and
    the block calls no function but the context's own two methods: no
    allocation of a context, no profiler and no CUDA call."""
    with profiling.recording() as rec:
        pass
    shared = profiling.span("a")
    assert profiling.span("b") is shared and profiling.request_span("c") is shared
    calls = []

    def hook(frame, event, arg):
        if event in ("call", "c_call"):
            calls.append(arg.__name__ if event == "c_call" else frame.f_code.co_name)

    sys.setprofile(hook)
    try:
        for name in ("x", "y"):
            with profiling.span(name):
                pass
            with profiling.request_span(name):
                pass
    finally:
        sys.setprofile(None)
    assert [c for c in calls if c != "setprofile"] == [
        "span", "__enter__", "__exit__", "request_span", "__enter__", "__exit__"] * 2
    assert rec.spans == [] and profiling._ACTIVE is None


INFER_SPANS = ["infer.request", "infer.upload", "infer.fbank", "infer.ast", "infer.sampler",
               "infer.decode"]


@pytest.fixture(scope="module")
def tiny_pipeline():
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig

    kw = (PriorConfig(latent_dim=16, ff_size=32, num_layers=3, num_heads=2),
          DenoiserConfig(latent_dim=16, ff_size=32, num_layers=3, num_heads=2, cond_dim=12),
          ASTConfig(embed_dim=16, depth=1, num_heads=2, feature_dim=12))
    return GesturePipeline(init_random_params(0, *kw), *kw, dtype=torch.float32,
                           num_inference_steps=2, device="cpu")


def _names_by_request(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.request, []).append(s.name)
    return out


@pytest.mark.parametrize("entry", ["wav_to_motion", "infer_wav"])
def test_inference_records_the_layer_spans(tiny_pipeline, entry):
    """Two calls are two requests, each with every span of its entry once:
    ``infer_wav``'s nested ``wav_to_motion`` opens no second root, and every
    other span is a child of the one root."""
    wave = np.random.default_rng(3).normal(size=2 * 160_000).astype(np.float32) * 0.1
    with profiling.recording() as rec:
        for _ in range(2):
            if entry == "infer_wav":
                tiny_pipeline.infer_wav(wave, seed=1)
            else:
                tiny_pipeline.wav_to_motion(wave.reshape(2, -1))
    want = INFER_SPANS + (["infer.download"] if entry == "infer_wav" else [])
    assert _names_by_request(rec.spans) == {0: want, 1: want}
    roots = [i for i, s in enumerate(rec.spans) if s.parent == -1]
    assert [rec.spans[i].name for i in roots] == ["infer.request"] * 2
    assert all(s.parent in roots for s in rec.spans if s.parent != -1)


def test_a_train_step_records_the_layer_spans():
    """batch_to_device outside a step is its own request (``train.upload``);
    a step records its root and each phase once, all children of the root."""
    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.train import audio as ta

    cfg = ta.AudioTrainConfig(freq_mask=8, time_mask=16)
    ast_cfg = ASTConfig(input_tdim=64, input_fdim=32, embed_dim=16, depth=1, num_heads=2,
                        feature_dim=12)
    state = ta.init_state(0, cfg, torch.float32, ast_cfg, device="cpu")
    step, _ = ta.make_train_step(cfg)
    rng = np.random.default_rng(4)
    batch = {"fbanks": rng.normal(size=(2, 4, 64, 32)).astype(np.float32),
             "emo_id": np.array([1, 2]), "a1_id": np.array([0, 3]), "a2_id": np.array([4, 5])}
    with profiling.recording() as rec:
        for _ in range(2):
            step(state, ta.batch_to_device(batch, torch.device("cpu")),
                 torch.Generator().manual_seed(0))
    want = ["train.step", "train.augment", "train.encode", "train.reconstruct", "train.loss",
            "train.backward", "train.optimizer"]
    assert _names_by_request(rec.spans) == {0: ["train.upload"], 1: want,
                                           2: ["train.upload"], 3: want}
    assert all(s.parent == -1 if s.name in ("train.step", "train.upload")
               else rec.spans[s.parent].name == "train.step" for s in rec.spans)


# ---------------------------------------------------------------- cluster/sweep.py


def _key(trials):
    return sorted((t.trial_id, t.rung, t.budget, round(t.score, 12), round(t.config["x"], 12))
                  for t in trials if t.state == "completed")


SPACE = {"x": sweep.Uniform(0, 1)}
JSPACE = {"x": jsweep.Uniform(0, 1)}


def _objective(c, b, i):
    return c["x"] / b


def _asha(module, space, path=None):
    return module.ASHA(space, _objective, min_budget=1, max_budget=9, reduction=3, seed=7,
                       out_file=path)


def test_sampling_matches_jax():
    for seed in range(4):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            assert sweep.sample_config(sweep.PRIOR_SPACE, rng) == jsweep.sample_config(
                jsweep.PRIOR_SPACE, jrng)
    assert sweep.Uniform(1e-5, 1e-1, log=True).sample(np.random.default_rng(1)) == \
        jsweep.Uniform(1e-5, 1e-1, log=True).sample(np.random.default_rng(1))


def test_asha_matches_jax_and_resumes(tmp_path):
    """A continuous run equals the JAX package's; a run stopped after 7 units
    and resumed from its ledger equals the continuous one."""
    cont = _asha(sweep, SPACE, tmp_path / "cont.jsonl")
    best = cont.run(12)
    jcont = _asha(jsweep, JSPACE)
    jbest = jcont.run(12)
    assert _key(cont.trials) == _key(jcont.trials)
    assert (best.trial_id, best.config) == (jbest.trial_id, jbest.config)
    _asha(sweep, SPACE, tmp_path / "resume.jsonl").run(7)
    resumed = _asha(sweep, SPACE, tmp_path / "resume.jsonl")
    assert len(resumed.trials) == 7
    resumed.run(5)
    assert _key(resumed.trials) == _key(cont.trials)


@pytest.mark.parametrize("cut", ["torn", "newline_lost"])
def test_asha_resumes_after_a_torn_last_line(tmp_path, cut):
    """A crash in the middle of a ledger write leaves a partial last line.
    The JAX package's sweep cannot resume from it (json.loads raises); the
    port cuts the line, redoes that unit, and two resumptions later still
    equals the continuous run. A whole last record whose newline was lost
    is kept, and the next record starts on a line of its own."""
    cont = _asha(sweep, SPACE)
    cont.run(12)
    path = tmp_path / "sweep.jsonl"
    _asha(sweep, SPACE, path).run(8)
    text = path.read_text()
    last = text.rstrip("\n").rsplit("\n", 1)[1]
    path.write_text(text[:-len(last) // 2] if cut == "torn" else text.rstrip("\n"))
    if cut == "torn":
        with pytest.raises(json.JSONDecodeError):
            _asha(jsweep, JSPACE, path)
    resumed = _asha(sweep, SPACE, path)
    assert len(resumed.trials) == (7 if cut == "torn" else 8)
    resumed.run(2)
    again = _asha(sweep, SPACE, path)
    again.run(12 - len(again.trials))
    assert _key(again.trials) == _key(cont.trials)
    assert all(json.loads(ln) for ln in path.read_text().splitlines())


def test_asha_refuses_damage_before_the_last_line(tmp_path):
    path = tmp_path / "sweep.jsonl"
    _asha(sweep, SPACE, path).run(4)
    lines = path.read_text().splitlines()
    lines[1] = lines[1][:10]
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match=":2: malformed ledger line"):
        _asha(sweep, SPACE, path)
