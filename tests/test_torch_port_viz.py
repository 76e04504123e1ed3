"""The port's render path and host-side CLI tasks against the JAX package, on the CPU.

``amuse_tpu_torch.viz.export`` (npz export, the Blender/ffmpeg argv, the
per-window render and mux), the four bpy shims under ``viz/blender/``,
``viz/blender_setup.py``, and the CLI tasks ``bvh2smplx_``, ``render_gt``,
``render_baselines``, ``blender_setup`` and the render wiring of
``infer_gesture``/``edit_gesture``, each beside its ``amuse_tpu``
counterpart. Neither Blender nor ffmpeg runs here: the JAX package's fakes
stand in (the recording ``bpy`` of ``tests/test_blender_scene.py`` and
``tests/test_blender_shims.py``, the fake Blender of
``tests/test_blender_setup.py``) beside stub binaries on PATH that record
their argv and create the mp4 they are asked for. Argv logs, reports, call
sequences and npz trees are held equal once the two packages' paths (their
scripts, their run directories) are replaced by one name; converted poses
through their rotation matrices atol 1e-5 (float32 in both).
"""

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import tests.test_blender_shims as jax_shim_tests
from amuse_tpu.cli import main as jcli
from amuse_tpu.cli.config import load_config as jload_config
from amuse_tpu.viz import blender_setup as jbs
from amuse_tpu.viz import export as jvx
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.viz import blender_setup as bs
from amuse_tpu_torch.viz import export as vx
from tests.test_blender_scene import make_fake_bpy
from tests.test_blender_setup import FAKE_BLENDER, _make_addon_tar
from tests.test_blender_shims import fake_bpy_for_bake
from tests.test_torch_port_host import assert_poses_close, make_rig, raw_beat_skeleton
from tests.test_torch_port_pipeline import TINY
from tests.torch_port_pipes import write_take

SHIMS = Path(vx.__file__).parent / "blender"
JSHIMS = Path(jvx.__file__).parent / "blender"
STUB = """#!/bin/sh
echo "{name} $@" >> {log}
out=""
for a in "$@"; do case "$a" in *.mp4) out="$a";; esac; done
{fail}[ -n "$out" ] && : > "$out"
exit 0
"""


def stub_bin(root: Path, fail_on: str = "") -> tuple[Path, Path]:
    """blender and ffmpeg stubs (shell builtins only) in ``root/bin``, which
    append their argv to ``root/calls.log`` and create the mp4 argument;
    blender exits 1 on an output path holding ``fail_on``. -> (bin, log)."""
    bindir, log = root / "bin", root / "calls.log"
    bindir.mkdir(parents=True)
    for name in ("blender", "ffmpeg"):
        fail = (f'case "$out" in *{fail_on}*) echo "render error" >&2; exit 1;; esac\n'
                if fail_on and name == "blender" else "")
        p = bindir / name
        p.write_text(STUB.format(name=name, log=log, fail=fail))
        p.chmod(0o755)
    return bindir, log


def normalised(text: str, subs: dict) -> str:
    for old, new in subs.items():
        text = text.replace(str(old), new)
    return text


def read_log(log: Path, subs: dict) -> list:
    return normalised(log.read_text(), subs).splitlines() if log.exists() else []


def npz_tree(root: Path) -> dict:
    """{relative path: {key: array}} of every npz under root."""
    out = {}
    for p in sorted(root.rglob("*.npz")):
        with np.load(p) as d:
            out[str(p.relative_to(root))] = {k: d[k] for k in d.files}
    return out


def assert_trees_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for rel in a:
        assert list(a[rel]) == list(b[rel]), rel
        for k in a[rel]:
            assert a[rel][k].dtype == b[rel][k].dtype, (rel, k)
            np.testing.assert_array_equal(a[rel][k], b[rel][k], err_msg=f"{rel}:{k}")


def _run_dir(out_dir: Path) -> Path:
    (run,) = Path(out_dir).iterdir()
    return run


# ---------------------------------------------------------------- viz/export.py


def test_export_and_layouts_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    result = {"poses": rng.normal(size=(3, 8, 55, 3)).astype(np.float32),
              "trans": rng.normal(size=(3, 8, 3)).astype(np.float32), "fps": 25.0}
    vx.export_windows(tmp_path / "port", result, subject="miranda", stem="take")
    jvx.export_windows(tmp_path / "jax", result, subject="miranda", stem="take")
    vx.write_smplx_npz(tmp_path / "port/x.npz", result["poses"][0], result["trans"][0],
                       gender="female", betas=np.ones(300))
    jvx.write_smplx_npz(tmp_path / "jax/x.npz", result["poses"][0], result["trans"][0],
                        gender="female", betas=np.ones(300))
    assert_trees_equal(npz_tree(tmp_path / "port"), npz_tree(tmp_path / "jax"))
    for n in range(1, 10):
        for cols in range(1, 5):
            assert vx.xstack_layout(n, cols) == jvx.xstack_layout(n, cols)
    kw = dict(fps=25.0, engine="CYCLES", preset="show", resolution=512, samples=8,
              blender_exe="/opt/b")
    assert vx.blender_argv("a.npz", "b.mp4", "s.py", **kw) == jvx.blender_argv(
        "a.npz", "b.mp4", "s.py", **kw)
    assert vx.DEFAULT_RENDER_SCRIPT.is_file()
    assert vx.DEFAULT_RENDER_SCRIPT.read_bytes() != jvx.DEFAULT_RENDER_SCRIPT.read_bytes()


def test_no_binaries_is_a_no_op_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    p = vx.write_smplx_npz(tmp_path / "seq_0" / "x.npz", np.zeros((4, 55, 3)), np.zeros((4, 3)))
    for mod in (vx, jvx):
        assert mod.render_windows([p], wav_path=tmp_path / "a.wav") == []
        assert not mod.render_with_blender(p, "o.mp4", render_script="s.py")
        assert not mod.mux_audio("a.mp4", "a.wav", "out.mp4")
        assert not mod.concat_grid(["a.mp4", "b.mp4"], "grid.mp4")
    assert not list(tmp_path.rglob("*.mp4"))


@pytest.mark.parametrize("fail_on", ["", "seq_1/"])
def test_render_windows_argv_matches_jax(tmp_path, monkeypatch, capsys, fail_on):
    """11 windows through the stubs, with audio and a scene preset: the same
    blender and ffmpeg argv as JAX once the render script and the directory
    are one name (seq_10 after seq_2, its audio at 100 s), the same videos;
    with a render failing on seq_1, that window alone is skipped in both."""
    outs, logs = {}, {}
    for name, mod in (("port", vx), ("jax", jvx)):
        root = tmp_path / name
        bindir, log = stub_bin(root, fail_on)
        monkeypatch.setenv("PATH", str(bindir))
        paths = [mod.write_smplx_npz(root / f"seq_{i}" / f"x_seq{i}.npz", np.zeros((4, 55, 3)),
                                     np.zeros((4, 3))) for i in range(11)]
        videos = mod.render_windows(paths[::-1], wav_path=root / "a.wav", preset="half",
                                    resolution=256)
        subs = {mod.DEFAULT_RENDER_SCRIPT: "<render_npz.py>", root: "<root>"}
        outs[name] = ([normalised(str(v), subs) for v in videos],
                      normalised(capsys.readouterr().out, subs))
        logs[name] = read_log(log, subs)
        assert mod.concat_grid(videos[:3], root / "grid.mp4", cols=2)
        logs[name] += read_log(log, subs)[len(logs[name]):]
    assert outs["port"] == outs["jax"] and logs["port"] == logs["jax"]
    blender = [c for c in logs["port"] if c.startswith("blender")]
    mux = [c for c in logs["port"] if c.startswith("ffmpeg") and "-ss" in c]
    assert len(blender) == 11 and len(mux) == (10 if fail_on else 11)
    assert "seq_10/" in blender[-1] and "-ss 100.0 -t 10.0" in mux[-1]
    assert blender[0].split(" -- ")[1].split()[3:] == ["BLENDER_EEVEE", "half", "256", "0"]
    assert ("render failed" in outs["port"][1]) == bool(fail_on)
    assert "xstack=inputs=3:layout=0_0|w0_0|0_h0" in logs["port"][-1]


# ------------------------------------------------------------- viz/blender/*.py


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports without bpy
    return mod


def _scene_record(bpy, scene) -> dict:
    """What a render_npz scene build left behind, on the fake bpy."""
    objects = [(o.type, o.name, list(o.location), tuple(o.rotation_euler),
                {k: v for k, v in vars(o.data).items() if k != "materials"},
                [m.name for m in o.data.materials], getattr(o, "light_type", None))
               for o in bpy.data.objects]
    materials = [(m.name, m.use_nodes, m.bsdf.subsurface_method,
                  {k: m.bsdf.inputs[k].default_value for k in m.bsdf.inputs._d})
                 for m in bpy.data.materials_created]
    r = scene.render
    return {"calls": bpy.calls, "objects": objects, "materials": materials,
            "render": (r.engine, r.fps, r.resolution_x, r.resolution_y, r.filepath,
                       r.image_settings.file_format, r.ffmpeg.format, r.ffmpeg.codec),
            "frames": (scene.frame_start, scene.frame_end), "cycles": vars(scene.cycles),
            "eevee": vars(scene.eevee), "camera": scene.camera.name}


@pytest.mark.parametrize("preset", ["full", "half", "show", "plain"])
@pytest.mark.parametrize("engine,samples,legacy", [("BLENDER_EEVEE", 0, False),
                                                   ("CYCLES", 64, False),
                                                   ("BLENDER_EEVEE", 32, True)])
def test_render_npz_scene_matches_jax(tmp_path, monkeypatch, preset, engine, samples, legacy):
    """Every preset's studio scene, on EEVEE, on CYCLES with samples, and on a
    Blender that refuses the legacy EEVEE name (4.2): the same operator
    calls, objects, materials and render settings as the JAX script's."""
    npz = vx.write_smplx_npz(tmp_path / "seq_0" / "m.npz", np.zeros((7, 55, 3)),
                             np.zeros((7, 3)), subject="miranda")
    cfg = {"npz": str(npz), "video": "out.mp4", "fps": 30.0, "engine": engine,
           "preset": preset, "resolution": 256, "samples": samples}
    records = []
    for path in (SHIMS / "render_npz.py", JSHIMS / "render_npz.py"):
        mod = _load(path, "render_npz_under_test")
        bpy = make_fake_bpy(reject_legacy_eevee=legacy)
        monkeypatch.setitem(sys.modules, "bpy", bpy)
        records.append(_scene_record(bpy, mod.build_scene(dict(cfg))))
    assert records[0] == records[1]
    assert records[0]["render"][0] == ("BLENDER_EEVEE_NEXT" if legacy else engine)


@pytest.mark.parametrize("argv", [["x.npz", "y.mp4"], ["x", "y", "25", "eevee", "SHOW", "512", "8"],
                                  ["x", "y", "30", "METAL"], ["x", "y", "30", "CYCLES", "closeup"]])
def test_render_npz_argv_matches_jax(argv):
    mine, ref = (_load(p / "render_npz.py", "render_npz_argv") for p in (SHIMS, JSHIMS))
    for name in ("PRESETS", "FLOOR_Z", "MATERIALS"):
        assert getattr(mine, name) == getattr(ref, name)
    try:
        want = ref.parse_argv(argv)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mine.parse_argv(argv)
    else:
        assert mine.parse_argv(argv) == want


def _bake_run(script: Path, argv: list, tmp_path: Path, names=("Basis", "A", "B", "C")):
    bpy, obj = fake_bpy_for_bake("Face", list(names))
    jax_shim_tests._run(script, argv, bpy)
    scene = bpy.context.scene
    return ([(b.name, b.value, b.keyed) for b in obj.data.shape_keys.key_blocks],
            obj.data.shape_keys.cleared, scene.render.fps, scene.frame_end,
            [(Path(f).name, on) for f, on in bpy.exports])


@pytest.mark.parametrize("case", ["json_missing_name", "npz", "dump", "no_mesh", "no_action"])
def test_bake_face_matches_jax(tmp_path, case, capsys):
    if case == "json_missing_name":
        w = tmp_path / "w.json"
        w.write_text(json.dumps({"names": ["A", "X", "C"],
                                 "frames": [[0.1, 0.9, 0.3], [0.4, 0.8, 0.6]]}))
        argv = ["bake", "Face", str(w), "25"]
    elif case == "npz":
        w = tmp_path / "w.npz"
        np.savez(w, expressions=np.random.default_rng(1).uniform(size=(5, 2)).astype(np.float32))
        argv = ["bake", "Face", str(w)]
    elif case == "dump":
        argv = ["dump", "Face", str(tmp_path / "objs")]
    else:
        argv = ["bake", "Ghost", "w.json"] if case == "no_mesh" else []
    results = []
    for script in (SHIMS / "bake_face.py", JSHIMS / "bake_face.py"):
        try:
            results.append(_bake_run(script, argv, tmp_path))
        except SystemExit as e:
            results.append(("exit", str(e.code)[:60]))
        results.append(capsys.readouterr().out)
    assert results[0] == results[2] and results[1] == results[3]


def _retarget_fake():
    """A recording bpy for retarget_bvh.py: each BVH import selects a new rig."""
    bpy = types.ModuleType("bpy")
    calls, rigs = [], []

    def import_bvh(filepath=None, rotate_mode=None):
        calls.append(("import", filepath, rotate_mode))
        rig = types.SimpleNamespace(name=f"rig{len(rigs)}", selected=None)
        rig.select_set = lambda v, _rig=rig: (calls.append(("select", _rig.name, v)),
                                              setattr(_rig, "selected", v))
        rigs.append(rig)
        bpy.context.selected_objects = [rig]

    layer = types.SimpleNamespace(objects=types.SimpleNamespace(active=None))
    bpy.context = types.SimpleNamespace(
        scene=types.SimpleNamespace(source_rig=None, target_rig=None),
        selected_objects=[], view_layer=layer)
    bpy.ops = types.SimpleNamespace(
        wm=types.SimpleNamespace(read_factory_settings=lambda use_empty: calls.append(
            ("factory", use_empty))),
        import_anim=types.SimpleNamespace(bvh=import_bvh),
        arp=types.SimpleNamespace(
            import_config=lambda filepath: calls.append(("arp_config", filepath)),
            auto_scale=lambda: calls.append(("arp_auto_scale",)),
            retarget=lambda: calls.append(("arp_retarget",))),
        object=types.SimpleNamespace(select_all=lambda action: calls.append(("select_all",
                                                                             action))),
        export_anim=types.SimpleNamespace(bvh=lambda filepath, root_transform_only: calls.append(
            ("export", filepath, root_transform_only))))
    return bpy, calls, layer


@pytest.mark.parametrize("argv", [["beat.bvh", "tpose.bvh", "out.npz", "map.json", "scott"],
                                  ["b.bvh", "t.bvh", "o.npz"]])
def test_retarget_bvh_matches_jax(argv, capsys):
    results = []
    for script in (SHIMS / "retarget_bvh.py", JSHIMS / "retarget_bvh.py"):
        bpy, calls, layer = _retarget_fake()
        jax_shim_tests._run(script, argv, bpy)
        scn = bpy.context.scene
        results.append((calls, scn.source_rig, scn.target_rig, layer.objects.active.name,
                        capsys.readouterr().out))
    assert results[0] == results[1]
    assert ("export", argv[2] + ".retargeted.bvh", False) in results[0][0]


@pytest.mark.parametrize("argv,fail", [(["install", "a.zip", "b.zip"], ()),
                                       (["enable", "smplx", "ghost"], ("ghost",)),
                                       (["probe"], ()), (["nope"], ()), ([], ())])
def test_setup_addons_matches_jax(argv, fail, capsys):
    results = []
    for script in (SHIMS / "setup_addons.py", JSHIMS / "setup_addons.py"):
        bpy, au, calls = jax_shim_tests.TestSetupAddons()._fake(enable_fail=set(fail))
        saved = sys.argv
        if not argv:  # no "--": the usage exit
            sys.argv = ["blender"]
        try:
            if argv:
                jax_shim_tests._run(script, argv, bpy, extra_modules=[("addon_utils", au)])
            else:
                sys.modules["bpy"], sys.modules["addon_utils"] = bpy, au
                import runpy
                runpy.run_path(str(script), run_name="__main__")
            code = None
        except SystemExit as e:
            code = str(e.code)
        finally:
            sys.argv = saved
            sys.modules.pop("bpy", None)
            sys.modules.pop("addon_utils", None)
        results.append((calls, code, capsys.readouterr().out))
    assert results[0] == results[1]


# ------------------------------------------------------------- viz/blender_setup.py


@pytest.fixture
def fake_blenders(tmp_path, monkeypatch):
    """tests/test_blender_setup.py's fake Blender on PATH; each package's run
    gets its own state file through set_state(name)."""
    exe = tmp_path / "bin" / "blender"
    exe.parent.mkdir()
    exe.write_text(FAKE_BLENDER.replace("#!/usr/bin/env python", f"#!{sys.executable}"))
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", str(exe.parent))
    return lambda name: monkeypatch.setenv("FAKE_BLENDER_STATE", str(tmp_path / f"{name}.json"))


def test_blender_setup_with_fake_blender_matches_jax(tmp_path, fake_blenders, capsys):
    """Archives of two addons (one tar.xz, one zip) and a stray file: the same
    reports and printed lines as JAX on the first run and on the second,
    which installs nothing more."""
    addons = tmp_path / "addons"
    addons.mkdir()
    _make_addon_tar(addons / "retarget_bvh.tar.xz", "retarget_bvh")
    import zipfile

    with zipfile.ZipFile(addons / "smplx_blender_addon_300.zip", "w") as zf:
        zf.writestr("smplx_blender_addon/__init__.py", "bl_info = {}\n")
    (addons / "auto_rig_pro.rar").write_text("not an archive")
    runs = {}
    for name, mod in (("port", bs), ("jax", jbs)):
        fake_blenders(name)
        runs[name] = []
        for _ in range(2):
            rep = mod.setup(addons)
            rep.print()
            runs[name].append((dataclasses.asdict(rep), capsys.readouterr().out))
    assert runs["port"] == runs["jax"]
    first, second = (r[0] for r in runs["port"])
    assert set(first["enabled"]) == {"retarget_bvh", "smplx_blender_addon"}
    assert second["installed"] == [] and not first["ok"]
    assert any("auto_rig_pro.rar: not a zip/tar archive" in e for e in first["errors"])


def test_blender_setup_without_blender_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    reps = []
    for mod in (bs, jbs):
        rep = mod.setup(tmp_path)
        rep.print()
        reps.append((dataclasses.asdict(rep), capsys.readouterr().out, mod.probe()))
    assert reps[0] == reps[1]
    assert not reps[0][0]["ok"] and "not found on PATH" in reps[0][1]
    import zipfile

    archive = tmp_path / "import_runtime_mhx2.tar.xz"
    _make_addon_tar(archive, "import_runtime_mhx2")
    names = []
    for mod in (bs, jbs):
        (tmp_path / mod.__name__).mkdir()
        names.append(zipfile.ZipFile(mod._as_installable_zip(archive, tmp_path / mod.__name__))
                     .namelist())
    assert names[0] == names[1] == ["import_runtime_mhx2/__init__.py"]
    assert bs._as_installable_zip(tmp_path / "a.rar", tmp_path) is None
    assert bs.KNOWN_ADDONS == jbs.KNOWN_ADDONS
    for module in ("retarget_bvh", "nope"):
        assert bs.KNOWN_ADDONS_GUIDE(module) == jbs.KNOWN_ADDONS_GUIDE(module)


def test_blender_setup_timeout_is_a_report_line_like_jax(monkeypatch):
    def wedged(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"], output=b"half a line")

    got = []
    for mod in (bs, jbs):
        monkeypatch.setattr(mod.subprocess, "run", wedged)
        rc = mod._run_blender("blender", ["probe"])
        got.append((rc.returncode, rc.stdout, rc.stderr))
    assert got[0] == got[1] == (124, "half a line", "blender timed out after 600s running probe")


def test_cli_blender_setup_exits_1_like_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    cfg = {"data": {"blender_addons_dir": str(tmp_path)}, "out_dir": str(tmp_path / "runs")}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    with pytest.raises(SystemExit) as e:
        cli.main(["--fn", "blender_setup", "--cfg", str(tmp_path / "c.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    with pytest.raises(SystemExit) as je:
        jcli.task_blender_setup(jload_config(None, cfg))
    assert e.value.code == je.value.code == 1 and out == capsys.readouterr().out
    assert "blender executable 'blender' not found on PATH" in out


# ------------------------------------------------------------------------ CLI tasks


def _cfg_pair(tmp_path, data: dict, **extra) -> tuple:
    """(port config file, JAX config) over one tree, each with its own out_dir."""
    base = {"data": data, **extra}
    port = tmp_path / "port.json"
    port.write_text(json.dumps({**base, "out_dir": str(tmp_path / "port_runs")}))
    return port, jload_config(None, {**base, "out_dir": str(tmp_path / "jax_runs")})


def _bvh_tree(tmp_path):
    beat = tmp_path / "beat"
    for d in ("2", "9"):
        (beat / d).mkdir(parents=True)
    make_rig(beat / "2" / "2_scott_0_9_9.bvh", 55, "ZYX", 30, seed=11)
    make_rig(beat / "2" / "2_scott_0_10_10.bvh", 55, "ZYX", 12, seed=12)
    raw_beat_skeleton(beat / "9" / "9_miranda_0_9_9.bvh")


def test_cli_bvh2smplx_matches_jax(tmp_path, monkeypatch, capsys):
    """Two retargeted SMPL-X takes and a raw 75-joint BEAT skeleton, without
    Blender: the same messages (the raw one skipped with the reference's
    reason), the same npz files; a second run converts nothing and keeps
    the files."""
    monkeypatch.setenv("PATH", str(tmp_path))
    _bvh_tree(tmp_path)
    roots = {k: tmp_path / f"mosh_{k}" for k in ("port", "jax")}
    port_cfg, _ = _cfg_pair(tmp_path, {"data_root": str(tmp_path / "beat"),
                                       "mosh_root": str(roots["port"])})
    jcfg = jload_config(None, {"data": {"data_root": str(tmp_path / "beat"),
                                        "mosh_root": str(roots["jax"])}, "debug": True})
    outs = {}
    for rnd in range(2):
        cli.main(["--fn", "bvh2smplx_", "--cfg", str(port_cfg), "--device", "cpu"])
        outs["port", rnd] = normalised(capsys.readouterr().out, {roots["port"]: "<mosh>"})
        jcli.task_bvh2smplx(jcfg)
        outs["jax", rnd] = normalised(capsys.readouterr().out, {roots["jax"]: "<mosh>"})
        if rnd == 0:
            mtimes = {p.name: p.stat().st_mtime_ns for p in roots["port"].iterdir()}
    assert outs["port", 0] == outs["jax", 0] and outs["port", 1] == outs["jax", 1]
    assert "converted 2, skipped 1" in outs["port", 0] and "converted 0, skipped 1" in outs[
        "port", 1]
    assert "9_miranda_0_9_9.bvh: 75-joint BEAT skeleton; retarget needs Blender" in outs["port", 0]
    assert mtimes == {p.name: p.stat().st_mtime_ns for p in roots["port"].iterdir()}
    _assert_converted_equal(roots["port"], roots["jax"], 2)


def _assert_converted_equal(port_root: Path, jax_root: Path, n: int) -> None:
    mine, ref = npz_tree(port_root), npz_tree(jax_root)
    assert list(mine) == list(ref) and len(mine) == n
    for rel in mine:
        for k in ("trans", "gender", "betas", "mocap_frame_rate"):
            np.testing.assert_array_equal(mine[rel][k], ref[rel][k])
        assert_poses_close(mine[rel]["poses"], ref[rel]["poses"])


def test_cli_bvh2smplx_blender_leg_matches_jax(tmp_path, monkeypatch, capsys):
    """With Blender (a stub that records its argv and writes the retargeted
    rig) and data.tpose_smplx_bvh set, the raw skeleton goes through each
    package's own retarget_bvh.py with the same arguments, and its npz is
    converted in the calling process."""
    _bvh_tree(tmp_path)
    rig, log = tmp_path / "retargeted.bvh", tmp_path / "blender.log"
    make_rig(rig, 55, "ZYX", 9, seed=13)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "blender").write_text(
        f"#!{sys.executable}\nimport shutil, sys\n"
        f"open({str(log)!r}, 'a').write('blender ' + ' '.join(sys.argv[1:]) + '\\n')\n"
        "args = sys.argv[sys.argv.index('--') + 1:]\n"
        f"shutil.copy({str(rig)!r}, args[2] + '.retargeted.bvh')\n")
    (bindir / "blender").chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    roots = {k: tmp_path / f"mosh_{k}" for k in ("port", "jax")}
    data = {"data_root": str(tmp_path / "beat"), "tpose_smplx_bvh": "tpose.bvh",
            "arp_preset": "map.json"}
    port_cfg, _ = _cfg_pair(tmp_path, {**data, "mosh_root": str(roots["port"])})
    cli.main(["--fn", "bvh2smplx_", "--cfg", str(port_cfg), "--device", "cpu"])
    jcli.task_bvh2smplx(jload_config(None, {"data": {**data, "mosh_root": str(roots["jax"])}}))
    calls = read_log(log, {SHIMS / "retarget_bvh.py": "<shim>", JSHIMS / "retarget_bvh.py": "<shim>",
                           roots["port"]: "<mosh>", roots["jax"]: "<mosh>"})
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0].endswith("-- " + str(tmp_path / "beat/9/9_miranda_0_9_9.bvh")
                             + " tpose.bvh <mosh>/9_miranda_0_9_9.npz map.json miranda")
    assert "converted 3, skipped 0" in capsys.readouterr().out
    for root in roots.values():  # the retargeted BVH stays beside the npz, as in JAX
        (root / "9_miranda_0_9_9.npz.retargeted.bvh").unlink()
    _assert_converted_equal(roots["port"], roots["jax"], 3)


def _mosh_tree(tmp_path, baselines: bool = False):
    """Three MoSh takes (2, 3 and 1 windows of 30 frames), a wav for one;
    with ``baselines``, three methods covering the first take and one also
    the third."""
    rng = np.random.default_rng(4)
    mosh = tmp_path / "mosh"
    mosh.mkdir()

    def motion(path, frames):
        np.savez(path, poses=(0.2 * rng.normal(size=(frames, 165))).astype(np.float32),
                 trans=(0.1 * rng.normal(size=(frames, 3))).astype(np.float32))

    for stem, frames in (("2_scott_0_9_9", 65), ("2_scott_0_10_10", 95),
                         ("9_miranda_0_9_9", 31)):
        motion(mosh / f"{stem}.npz", frames)
    (tmp_path / "beat" / "2").mkdir(parents=True)
    (tmp_path / "beat" / "2" / "2_scott_0_9_9.wav").write_bytes(b"")
    if baselines:
        for method in ("camn", "mdm", "trimodal"):
            (tmp_path / "baselines" / method).mkdir(parents=True)
            motion(tmp_path / "baselines" / method / "2_scott_0_9_9.npz", 62)
        motion(tmp_path / "baselines" / "mdm" / "9_miranda_0_9_9.npz", 40)
    return {"mosh_root": str(mosh), "data_root": str(tmp_path / "beat"),
            "baselines_root": str(tmp_path / "baselines"), "window_frames": 30}


@pytest.mark.parametrize("task", ["render_gt", "render_baselines"])
@pytest.mark.parametrize("binaries", [False, True])
def test_cli_render_tasks_match_jax(tmp_path, monkeypatch, capsys, task, binaries):
    """render_gt and render_baselines of both packages on one tree, without
    binaries and with the stubs: the window npz trees equal file by file,
    the same messages and the same blender/ffmpeg argv. render_baselines
    slices GT only for the two covered takes and renders each once,
    whatever the number of methods covering it."""
    data = _mosh_tree(tmp_path, baselines=task == "render_baselines")
    port_cfg, jcfg = _cfg_pair(tmp_path, data)
    bindir, log = stub_bin(tmp_path)
    monkeypatch.setenv("PATH", str(bindir) if binaries else str(tmp_path / "beat"))
    cli.main(["--fn", task, "--cfg", str(port_cfg), "--device", "cpu"])
    run = _run_dir(tmp_path / "port_runs")
    subs = {run: "<run>", vx.DEFAULT_RENDER_SCRIPT: "<render_npz.py>"}
    out, calls = normalised(capsys.readouterr().out, subs), read_log(log, subs)
    log.unlink(missing_ok=True)
    getattr(jcli, "task_" + task)(jcfg)
    jrun = _run_dir(tmp_path / "jax_runs")
    jsubs = {jrun: "<run>", jvx.DEFAULT_RENDER_SCRIPT: "<render_npz.py>"}
    assert out == normalised(capsys.readouterr().out, jsubs)
    assert calls == read_log(log, jsubs)
    mine = npz_tree(run)
    assert_trees_equal(mine, npz_tree(jrun))
    assert sorted({p.split("/")[1] for p in mine if p.startswith("GT/")}) == (
        ["2_scott_0_10_10", "2_scott_0_9_9", "9_miranda_0_9_9"] if task == "render_gt"
        else ["2_scott_0_9_9", "9_miranda_0_9_9"])
    renders = [c for c in calls if c.startswith("blender")]
    if not binaries:
        assert not calls and "blender not on PATH" in out
    elif task == "render_gt":
        assert len(renders) == 6 and sum("-ss" in c for c in calls) == 2  # one take has audio
    else:
        gt = [c for c in renders if "<run>/GT/" in c]
        assert len(gt) == 2 + 1 and len(renders) == 3 + 3 * 2 + 1
        assert sum("xstack" in c for c in calls) == 3 * 2 + 1


def test_edit_exports_and_grids_match_jax(tmp_path, monkeypatch, capsys):
    """_export_edit_results of both packages on the same variants, through the
    stubs: per variant each window rendered, the first video of every
    variant into the source's comparison grid (2 columns for 2 variants, 4
    for 5), the jaw zeroed in the npz; the same argv and npz trees."""
    rng = np.random.default_rng(9)

    def variant(windows):
        return (rng.normal(size=(windows, 6, 55, 3)).astype(np.float32),
                rng.normal(size=(windows, 6, 3)).astype(np.float32))

    results = {"scott_0_9_9": {"self": variant(2), "emo_happy": variant(2)},
               "miranda_0_9_9": {f"v{i}": variant(1) for i in range(5)},
               "lu_0_9_9": {"self": variant(1)}}
    viz = {"engine": "BLENDER_EEVEE", "preset": "plain", "resolution": 64, "samples": 0}
    logs, trees = [], []
    for name, mod in (("port", cli), ("jax", jcli)):
        bindir, log = stub_bin(tmp_path / name)
        monkeypatch.setenv("PATH", str(bindir))
        mod._export_edit_results(tmp_path / name / "run", "emotion_control/rep0", results, viz)
        subs = {tmp_path / name: "<root>", vx.DEFAULT_RENDER_SCRIPT: "<render_npz.py>",
                jvx.DEFAULT_RENDER_SCRIPT: "<render_npz.py>"}
        logs.append((read_log(log, subs), normalised(capsys.readouterr().out, subs)))
        trees.append(npz_tree(tmp_path / name / "run"))
    assert logs[0] == logs[1]
    assert_trees_equal(trees[0], trees[1])
    grids = [c for c in logs[0][0] if "xstack" in c]
    assert len(grids) == 2 and "inputs=2:layout=0_0|w0_0 " in grids[0]
    assert "inputs=5:layout=0_0|w0_0|w0+w0_0|w0+w0+w0_0|0_h0 " in grids[1]
    assert grids[0].endswith("scott_0_9_9/comparison_grid.mp4")
    assert sum(c.startswith("blender") for c in logs[0][0]) == 2 * 2 + 5 + 1
    assert all(np.all(d["poses"][:, 22] == 0) for d in trees[0].values())


def _tiny_config(tmp_path, **extra) -> Path:
    cfg = dict(TINY, out_dir=str(tmp_path / "runs"), **extra)
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    return tmp_path / "tiny.json"


def test_cli_infer_gesture_renders_each_window(tmp_path, monkeypatch, capsys):
    """--fn infer_gesture through the stubs: one render and one mux of the
    matching 10 s of audio per window."""
    from amuse_tpu_torch.audio.wavio import save_wav

    monkeypatch.delenv("AMUSE_TPU_CKPT", raising=False)
    (tmp_path / "wavs").mkdir()
    save_wav(tmp_path / "wavs" / "2_scott_0_9_9.wav",
             np.random.default_rng(6).normal(scale=0.05, size=330000).astype(np.float32))
    bindir, log = stub_bin(tmp_path)
    monkeypatch.setenv("PATH", str(bindir))
    cli.main(["--fn", "infer_gesture", "--cfg", str(_tiny_config(tmp_path)), "--wav-dir",
              str(tmp_path / "wavs"), "--device", "cpu"])
    calls = log.read_text().splitlines()
    renders = [c for c in calls if c.startswith("blender")]
    muxes = [c for c in calls if c.startswith("ffmpeg")]
    assert len(renders) == len(muxes) == 2
    assert "-ss 0.0 -t 10.0" in muxes[0] and "-ss 10.0 -t 10.0" in muxes[1]
    assert str(vx.DEFAULT_RENDER_SCRIPT) in renders[0]
    assert "[infer] rendered 2 videos" in capsys.readouterr().out
    run = _run_dir(tmp_path / "runs")
    assert len(list(run.rglob("*_smplx_audio.mp4"))) == 2


def test_cli_edit_gesture_renders_and_grids(tmp_path, monkeypatch, capsys):
    """--fn edit_gesture (emotion_control over two takes of one window, and
    the demo swap, which is not rendered, as in JAX) through the stubs: one
    render per window of each variant, one comparison grid per source."""
    from amuse_tpu_torch.audio.wavio import save_wav

    monkeypatch.delenv("AMUSE_TPU_CKPT", raising=False)
    rng = np.random.default_rng(7)
    for take, emotion in (("0_9_9", 0), ("0_65_65", 1)):
        write_take(tmp_path, 2, "scott", take, 1, rng, emotion=emotion)
    demo = tmp_path / "viz_dump" / "test" / "e_speech"
    demo.mkdir(parents=True)
    for name in ("source_neutral.wav", "target_happy.wav"):
        save_wav(demo / name, rng.normal(scale=0.05, size=170000).astype(np.float32))
    cfg = _tiny_config(tmp_path, data={"data_root": str(tmp_path / "beat"),
                                       "mosh_root": str(tmp_path / "mosh")},
                       test={"emotion_control": True, "actors": ["scott"]})
    bindir, log = stub_bin(tmp_path)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.chdir(tmp_path)
    cli.main(["--fn", "edit_gesture", "--cfg", str(cfg), "--device", "cpu"])
    calls = log.read_text().splitlines()
    run = _run_dir(tmp_path / "runs")
    assert sum(c.startswith("blender") for c in calls) == 2 * 2  # 2 sources x 2 variants
    grids = sorted(run.rglob("comparison_grid.mp4"))
    assert [g.parent.name for g in grids] == ["scott_0_65_65", "scott_0_9_9"]
    assert not list((run / "e_gesture").rglob("*.mp4")) and list((run / "e_gesture").rglob(
        "*.npz"))
    assert "not ported" not in capsys.readouterr().out


def test_every_task_of_the_jax_cli_runs(capsys):
    """The port's --fn takes exactly the JAX CLI's eleven tasks."""
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    listed = re.search(r"--fn \{([^}]*)\}", capsys.readouterr().out).group(1).split(",")
    assert sorted(listed) == sorted(jcli.TASKS) and len(listed) == 11
