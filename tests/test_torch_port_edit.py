"""The port's gesture editing against the JAX package, on the CPU.

``amuse_tpu_torch.infer.editing`` and ``amuse_tpu.infer.editing`` run on the
same small weights (``tests/torch_port_pipes.py``: the widths of
``tests/test_editing.py``, float32), with the initial DDIM latents and the
VAE's reparameterisation noise injected on both sides by test-side
wrappers. Bounds: features atol 1e-4; poses (as rotation matrices) and
translation atol 1e-3, rtol 1e-3 (those of ``test_torch_port_pipeline.py``).
Also here: the JAX tests of the editing semantics, the eval sets and the
MoSh frame rate, mirrored on the port; ``beat.discover`` against JAX; and
``--fn edit_gesture --device cpu`` against the JAX CLI.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from amuse_tpu.cli import main as jcli
from amuse_tpu.cli.config import load_config as jload_config
from amuse_tpu.data import beat as jbeat
from amuse_tpu.infer import editing as jediting
from amuse_tpu_torch.audio.wavio import save_wav
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.data import beat, eval_sets
from amuse_tpu_torch.infer import editing
from amuse_tpu_torch.infer.editing import TakeLatents
from tests.torch_port_pipes import (
    FEAT_ATOL,
    JaxNoise,
    PortNoise,
    assert_motion_close,
    make_pipes,
    write_take,
)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline), both with injected noise, and the bare port."""
    jpipe, port = make_pipes(0)
    return JaxNoise(jpipe), PortNoise(port), port


def _wave(seed: int, windows: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        scale=0.05, size=(1, windows * 160000 + 1234)).astype(np.float32)


def _motion(seed: int, windows: int) -> np.ndarray:
    rng = np.random.default_rng(100 + seed)
    t = windows * 300 + 5
    return np.concatenate([0.2 * rng.normal(size=(t, 165)), 0.1 * rng.normal(size=(t, 3))],
                          axis=1).astype(np.float32)


# (actor, take, audio windows, motion windows or None)
TAKES = {
    "s9": ("scott", "0_9_9", 2, 2),
    "s65": ("scott", "0_65_65", 3, 2),  # cut to the 2 motion windows
    "s73": ("scott", "0_73_73", 3, None),
    "m9": ("miranda", "0_9_9", 2, 2),
    "m65": ("miranda", "0_65_65", 2, None),
}


@pytest.fixture(scope="module")
def encoded(pipes):
    """Each take of TAKES encoded by both packages -> {name: (jax, port)}."""
    jp, tp, _ = pipes
    out = {}
    for i, (name, (actor, take, aw, mw)) in enumerate(TAKES.items()):
        motion = None if mw is None else _motion(i, mw)
        out[name] = (jediting.encode_take(jp, actor, take, i, _wave(i, aw), motion, seed=11),
                     editing.encode_take(tp, actor, take, i, _wave(i, aw), motion, seed=11))
    return out


@pytest.mark.parametrize("name", list(TAKES))
def test_encode_take_matches_jax(encoded, name):
    """Features, the window cut to the motion and the sampled motion latents."""
    j, t = encoded[name]
    assert (t.actor, t.take, t.emo_label) == (j.actor, j.take, j.emo_label)
    for k in ("con", "emo", "sty"):
        assert t.__dict__[k].shape == j.__dict__[k].shape
        np.testing.assert_allclose(t.__dict__[k].numpy(), j.__dict__[k], atol=FEAT_ATOL,
                                   rtol=1e-3)
    assert (t.z_motion is None) == (j.z_motion is None) == (TAKES[name][3] is None)
    if t.z_motion is not None:
        np.testing.assert_allclose(t.z_motion.numpy(), j.z_motion, atol=FEAT_ATOL, rtol=1e-3)


def _run(module, pipe, task: str, takes: dict):
    """One editing task of ``module`` on the TakeLatents ``takes`` (one package's)."""
    if task == "emotion_control":
        return module.emotion_control(pipe, [takes[k] for k in ("s9", "s65", "s73")], seed=3)
    if task.startswith("style_transfer"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = module.style_transfer(pipe, [takes["s9"], takes["s73"]], [takes["m9"]],
                                        seed=3, reference_quirk=task.endswith("quirk"))
        assert any("2 vs 1 takes" in str(x.message) for x in w)
        return out
    if task == "style_xemo_transfer":
        return module.style_xemo_transfer(pipe, takes["s9"], takes["s65"], takes["m9"],
                                          takes["m65"], seed=4)
    if task == "content_control":
        return module.content_control(pipe, [takes["s9"], takes["s73"]], seed=5)
    raise ValueError(task)


@pytest.mark.parametrize("task", ["emotion_control", "style_transfer_quirk",
                                  "style_transfer_straight", "style_xemo_transfer",
                                  "content_control"])
def test_task_matches_jax(pipes, encoded, task):
    jp, tp, _ = pipes
    want = _run(jediting, jp, task, {k: v[0] for k, v in encoded.items()})
    got = _run(editing, tp, task, {k: v[1] for k, v in encoded.items()})
    assert got.keys() == want.keys()
    for source, variants in want.items():
        assert got[source].keys() == variants.keys()
        for variant, motion in variants.items():
            assert_motion_close(got[source][variant], motion)


def test_demo_emotion_swap_matches_jax(pipes):
    jp, tp, _ = pipes
    src, tgt = _wave(20, 3), _wave(21, 2)
    want = jediting.demo_emotion_swap(jp, src, tgt, seed=6)
    got = editing.demo_emotion_swap(tp, src, tgt, seed=6)
    assert got.keys() == want.keys() == {"original", "emotion_swapped"}
    for k in want:
        assert got[k][0].shape == (2, 12, 55, 3)
        assert_motion_close(got[k], want[k])


def test_variant_with_own_conditioning_is_self(pipes, encoded):
    """Each generate_with seeds a generator of its own: a variant given the
    source's own conditioning is bit-equal to "self", and the noise does not
    advance across calls."""
    _, _, port = pipes
    src = encoded["s9"][1]
    twin = dataclasses.replace(src, take="0_10_10")  # the same emotion latent
    out = editing.emotion_control(port, [src, twin], seed=9)
    res = out["scott_0_9_9"]
    for a, b in zip(res["self"], res["emo_0_10_10"]):
        np.testing.assert_array_equal(a, b)
    again = editing.generate_with(port, src.con, src.emo, src.sty, seed=9)
    for a, b in zip(res["self"], again):
        np.testing.assert_array_equal(a, b)
    other_seed = editing.generate_with(port, src.con, src.emo, src.sty, seed=10)
    assert not np.allclose(res["self"][0], other_seed[0])


# ---------------------------------------------- tests/test_editing.py, on the port


def _mk_take(actor, take, emo_label, seed, dim=8):
    rng = np.random.default_rng(seed)
    return TakeLatents(actor, take, emo_label,
                       *(torch.from_numpy(rng.normal(size=(1, dim)).astype(np.float32))
                         for _ in range(3)))


@pytest.mark.parametrize("case", ["quirk_crosswise", "xemo_diagonal", "content_only"])
def test_editing_semantics(pipes, case):
    """The key and crosswise checks of tests/test_editing.py."""
    _, _, port = pipes
    if case == "quirk_crosswise":
        a1 = [_mk_take("scott", "0_65_65", 1, 1), _mk_take("scott", "0_66_66", 1, 2)]
        a2 = [_mk_take("miranda", "0_65_65", 1, 3), _mk_take("miranda", "0_66_66", 1, 4)]
        quirk = editing.style_transfer(port, a1, a2, reference_quirk=True)
        straight = editing.style_transfer(port, a1, a2, reference_quirk=False)
        assert set(quirk) == {"scott_0_65_65", "scott_0_66_66", "miranda_0_65_65",
                              "miranda_0_66_66"}
        assert not np.allclose(quirk["scott_0_65_65"]["sty_miranda"][0],
                               straight["scott_0_65_65"]["sty_miranda"][0])
        np.testing.assert_array_equal(quirk["scott_0_65_65"]["self"][0],
                                      straight["scott_0_65_65"]["self"][0])
    elif case == "xemo_diagonal":
        out = editing.style_xemo_transfer(
            port, _mk_take("scott", "0_73_73", 2, 5), _mk_take("scott", "0_65_65", 1, 6),
            _mk_take("miranda", "0_73_73", 2, 7), _mk_take("miranda", "0_65_65", 1, 8))
        assert "xfer_miranda_0_65_65" in out["scott_0_73_73"]
        assert "xfer_scott_0_65_65" in out["miranda_0_73_73"]
        assert "xfer_miranda_0_73_73" in out["scott_0_65_65"]
        assert "xfer_scott_0_73_73" in out["miranda_0_65_65"]
    else:
        out = editing.content_control(port, [_mk_take("scott", "0_9_9", 0, 9),
                                             _mk_take("scott", "0_65_65", 1, 10)])
        r = out["scott_0_9_9"]
        assert set(r) == {"self", "con_0_65_65"}
        assert not np.allclose(r["self"][0], r["con_0_65_65"][0])


# ------------------------------------------------ tests/test_eval_sets.py, on the port


def _tree(root, spec):
    """{(actor_id, name): [takes]} -> the port's discovered takes (1 window each)."""
    rng = np.random.default_rng(0)
    (root / "beat").mkdir(parents=True, exist_ok=True)
    for (actor_id, name), takes in spec.items():
        for take in takes:
            write_take(root, actor_id, name, take, 1, rng, extra_samples=10000)
    return beat.discover(root / "beat", root / "mosh")


BOTH = ["0_73_73", "0_74_74", "0_65_65", "0_66_66"]


@pytest.mark.parametrize("case", ["emotion_control_skips_missing", "emotion_control_empty_tree",
                                  "style_transfer_under_two_takes", "xemo_missing_corner",
                                  "xemo_no_rng_first_take", "xemo_rng_draw"])
def test_eval_sets(tmp_path, case):
    if case == "emotion_control_skips_missing":
        takes = _tree(tmp_path, {(2, "scott"): ["0_65_65"]})
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            items = eval_sets.emotion_control_set(takes, "scott", ["happy", "angry"])
        assert [i.emotion for i in items] == ["happy"]
        assert any("angry" in str(x.message) for x in w)
        assert items[0].motion.shape == (307, 168) and items[0].waveform.shape[0] == 1
    elif case == "emotion_control_empty_tree":
        takes = _tree(tmp_path, {(2, "scott"): []})
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("ignore")
            assert eval_sets.emotion_control_set(takes, "scott", ["happy"]) == []
    elif case == "style_transfer_under_two_takes":
        takes = _tree(tmp_path, {(2, "scott"): ["0_65_65", "0_66_66"],
                                 (9, "miranda"): ["0_65_65"]})
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            a1, a2 = eval_sets.style_transfer_set(takes, "scott", "miranda", "happy")
        assert (len(a1), len(a2)) == (2, 1)
        assert any("miranda has 1/2" in str(x.message) for x in w)
    elif case == "xemo_missing_corner":
        takes = _tree(tmp_path, {(2, "scott"): ["0_73_73"]})
        with pytest.raises(FileNotFoundError, match="0_65_65 for actor scott"):
            eval_sets.style_xemo_set(takes, "scott", "miranda", "angry", "happy")
    elif case == "xemo_no_rng_first_take":
        takes = _tree(tmp_path, {(2, "scott"): BOTH, (9, "miranda"): BOTH})
        corners = eval_sets.style_xemo_set(takes, "scott", "miranda", "angry", "happy")
        assert corners["a1_e1"].take == "0_73_73" and corners["a1_e2"].take == "0_65_65"
    else:
        takes = _tree(tmp_path, {(2, "scott"): BOTH, (9, "miranda"): BOTH})
        drawn = set()
        for seed in range(8):
            c = eval_sets.style_xemo_set(takes, "scott", "miranda", "angry", "happy",
                                         rng=np.random.default_rng(seed))
            assert c["a1_e1"].take == c["a2_e1"].take and c["a1_e2"].take == c["a2_e2"].take
            drawn.add((c["a1_e1"].take, c["a1_e2"].take))
            again = eval_sets.style_xemo_set(takes, "scott", "miranda", "angry", "happy",
                                             rng=np.random.default_rng(seed))
            assert again["a1_e1"].take == c["a1_e1"].take
        assert {t[0] for t in drawn} == {"0_73_73", "0_74_74"}


# ------------------------------- tests/test_data_review_regressions.py, on the port


@pytest.mark.parametrize("rate,frames", [(120.0, 30), (30.0, 120), (25.0, None)])
def test_mosh_frame_rate(tmp_path, rate, frames):
    t = 120
    np.savez(tmp_path / "m.npz", poses=np.arange(t * 165, dtype=np.float32).reshape(t, 165),
             trans=np.zeros((t, 3), np.float32), mocap_frame_rate=np.asarray(rate))
    if frames is None:
        with pytest.raises(ValueError, match="mocap_frame_rate"):
            beat.load_mosh_motion(tmp_path / "m.npz")
        return
    m = beat.load_mosh_motion(tmp_path / "m.npz")
    np.testing.assert_array_equal(m, jbeat.load_mosh_motion(tmp_path / "m.npz"))
    assert m.shape == (frames, 168)
    stride = t // frames
    np.testing.assert_array_equal(m[1, :165], np.arange(stride * 165, (stride + 1) * 165,
                                                        dtype=np.float32))


def test_discover_matches_jax(tmp_path):
    """Take records, the stage-2 subset and the emotion labels of a tree
    with a non-English take, a take without motion, a BVH sibling, a
    non-pretrained take number, an excluded stage-2 actor and a malformed CSV."""
    rng = np.random.default_rng(1)
    write_take(tmp_path, 2, "scott", "0_9_9", 1, rng, emotion=3)
    write_take(tmp_path, 2, "scott", "1_9_9", 1, rng)  # not English
    write_take(tmp_path, 2, "scott", "0_12_12", 1, rng)  # no pretrained take
    write_take(tmp_path, 9, "miranda", "0_65_65", 1, rng, motion=False)
    write_take(tmp_path, 11, "nidal", "0_9_9", 1, rng)  # not a stage-2 actor
    (tmp_path / "beat" / "2" / "2_scott_0_9_9.bvh").write_text("HIERARCHY\n")
    (tmp_path / "beat" / "9" / "9_miranda_0_65_65.csv").write_text("a,b\n")
    (tmp_path / "beat" / "99").mkdir()  # not an actor id
    for english_only in (True, False):
        got = beat.discover(tmp_path / "beat", tmp_path / "mosh", english_only)
        want = jbeat.discover(tmp_path / "beat", tmp_path / "mosh", english_only)
        assert [dataclasses.astuple(t) for t in got] == [dataclasses.astuple(t) for t in want]
        assert len(got) == (4 if english_only else 5)
    got = beat.discover(tmp_path / "beat", tmp_path / "mosh")
    want = jbeat.discover(tmp_path / "beat", tmp_path / "mosh")
    assert ([t.take for t in beat.stage2_subset(got)]
            == [t.take for t in jbeat.stage2_subset(want)] == ["0_9_9"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        labels = [beat.emotion_label(t.emotion_csv) for t in got]
    assert sorted(labels) == [0, 0, 0, 3] and any("unparseable" in str(x.message) for x in w)
    assert labels == [jbeat.emotion_label(t.emotion_csv) for t in want]


# ------------------------------------------------------------------ the CLI


def test_cli_edit_gesture_matches_jax(pipes, tmp_path, monkeypatch, capsys):
    """``--fn edit_gesture --device cpu``: emotion_control over a synthetic
    tree and the demo swap, two replications, on the same weights and
    noise as the JAX CLI (``_make_pipeline`` of each returns the module's
    pipelines): the same rep<N> npz files, poses and translation within the
    bounds above, and rep0 differs from rep1."""
    jp, tp, _ = pipes
    rng = np.random.default_rng(2)
    for take, emotion in (("0_9_9", 0), ("0_65_65", 1)):  # 2 windows: JAX's compiled N
        write_take(tmp_path, 2, "scott", take, 2, rng, emotion=emotion)
    demo = tmp_path / "viz_dump" / "test" / "e_speech"
    demo.mkdir(parents=True)
    for name in ("source_neutral.wav", "target_happy.wav"):
        save_wav(demo / name, rng.normal(scale=0.05, size=330000).astype(np.float32))
    cfg = {"data": {"data_root": str(tmp_path / "beat"), "mosh_root": str(tmp_path / "mosh")},
           "test": {"emotion_control": True, "actors": ["scott"], "replication_times": 2}}
    (tmp_path / "port.json").write_text(json.dumps({**cfg, "out_dir": str(tmp_path / "port")}))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", str(demo))  # neither Blender nor ffmpeg
    monkeypatch.setattr(jcli, "_make_pipeline", lambda cfg: jp)
    monkeypatch.setattr(cli, "_make_pipeline", lambda cfg, device: tp)
    jcli.task_edit_gesture(jload_config(None, {**cfg, "out_dir": str(tmp_path / "jax")}))
    jout = capsys.readouterr().out
    cli.main(["--fn", "edit_gesture", "--cfg", str(tmp_path / "port.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    (jrun,), (run,) = (tmp_path / "jax").iterdir(), (tmp_path / "port").iterdir()
    # the same messages, and no video without the binaries
    assert out.replace(str(run), "<run>") == jout.replace(str(jrun), "<run>")
    assert not list(run.rglob("*.mp4")) and not list(jrun.rglob("*.mp4"))
    files = sorted(p.relative_to(run) for p in run.rglob("*.npz"))
    assert files == sorted(p.relative_to(jrun) for p in jrun.rglob("*.npz"))
    assert len(files) == 2 * (2 * 2 + 2) * 2  # reps x (2 sources x 2 variants + 2 demo) x 2
    for rel in files:
        d, jd = np.load(run / rel), np.load(jrun / rel)
        assert str(d["gender"]) == str(jd["gender"])
        np.testing.assert_array_equal(d["betas"], jd["betas"])
        assert_motion_close((d["poses"], d["trans"]), (jd["poses"], jd["trans"]))
    ctl = Path("emotion_control")
    for rel in (ctl / "rep{}/scott_0_9_9/self/seq_0/scott_self_seq0_smplx.npz",
                Path("e_gesture/rep{}/original/seq_0/_original_seq0_smplx.npz")):
        r0, r1 = (np.load(run / str(rel).format(r))["poses"] for r in (0, 1))
        assert not np.allclose(r0, r1)
    for rel in files:  # the edit tasks zero the jaw; the demo, as in JAX, does not
        jaw = np.abs(np.load(run / rel)["poses"][:, 22]).sum()
        assert (jaw == 0) == (rel.parts[0] == "emotion_control")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--fn", "edit_gesture", "--cfg", str(tmp_path / "port.json")])
