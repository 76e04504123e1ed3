"""BENCHMARK.json against the contract's form, and the harness finding a
new configuration, mix, cell and metric by name with no edit."""

from __future__ import annotations

import importlib
import json
import re
import shutil
import statistics
import sys
import time
from pathlib import Path

import pytest

from portbench import manifest
from portbench.run import Context, Window
from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def bench() -> dict:
    return manifest.load_manifest(ROOT)


def test_shape_of_the_manifest(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(text_ok(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    for kind, keys in KEYS.items():
        for entry in bench[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (kind, entry["name"])


def test_names_units_and_texts(bench):
    names = [e["name"] for kind in KEYS for e in bench[kind]]
    for kind in KEYS:
        kind_names = [e["name"] for e in bench[kind]]
        assert len(kind_names) == len(set(kind_names)), kind
    assert all(NAME.match(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert text_ok(c["source"]) and text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and text_ok(w["why"])
        assert w["chips"] in (1, 4)
    assert all(text_ok(m["layer"]) for m in bench["per_layer"])


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_every_piece_is_found_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert json.loads(path.read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = manifest.cell(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
        for name in cell.settings["check"]["limits"]:
            assert NAME.match(name)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
        for w in m.get("workloads", []):
            assert any(x["name"] == w for x in bench["workloads"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_a_new_cell_needs_no_edit(tmp_path):
    """A configuration, a mix, a cell and a metric added as files and
    entries, in a copy, are found by their names."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load_manifest(ROOT)
    pkg = root / "portbench"
    cfg = json.loads((pkg / "configs" / "amuse-infer.json").read_text())
    cfg["name"] = "amuse-infer-f32"
    cfg["ast"]["dtype"] = "float32"
    (pkg / "configs" / "amuse-infer-f32.json").write_text(json.dumps(cfg))
    mix = json.loads((pkg / "traffic" / "b32.json").read_text())
    (pkg / "traffic" / "b8.json").write_text(json.dumps({**mix, "samples_per_request": [8]}))
    (pkg / "workloads" / "infer32.b8.json").write_text(
        (pkg / "workloads" / "infer.b32.json").read_text())
    (pkg / "metrics" / "clip_latency_p50_ms.b8.py").write_text(
        "import statistics\n\n\ndef read(ctx):\n"
        "    return 1e3 * statistics.median(d.end - d.start for d in ctx.window.done)\n")
    bench["configs"].append({**bench["configs"][0], "name": "amuse-infer-f32",
                             "file": "portbench/configs/amuse-infer-f32.json"})
    bench["workloads"].append({"name": "infer32.b8", "config": "amuse-infer-f32",
                               "traffic": "b8", "chips": 1, "why": "float32 AST, 8 windows"})
    bench["per_layer"].append({"name": "clip_latency_p50_ms.b8", "unit": "ms",
                               "better": "lower", "source": "host_clock", "layer": "pipeline",
                               "moves": "setup_s", "workloads": ["infer32.b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell(root, "infer32.b8", pkg=pkg)
    assert cell.config["ast"]["dtype"] == "float32"
    assert cell.traffic["samples_per_request"] == [8]
    assert [m["name"] for m in cell.per_layer] == ["clip_latency_p50_ms.b8"]
    reader = manifest.reader("clip_latency_p50_ms.b8", pkg=pkg)

    class Done:
        def __init__(self, start, end):
            self.start, self.end = start, end

    ctx = Context(cell.config, 1.0, Window(0.0, 1.0, [Done(0, 0.01), Done(0, 0.03)]))
    assert reader.read(ctx) == pytest.approx(1e3 * statistics.median([0.01, 0.03]))
    with pytest.raises(KeyError):
        manifest.cell(root, "no.such.cell", pkg=pkg)


def test_a_new_entry_needs_no_edit_of_the_generator():
    """The generator drives any entry; each system names the entries it
    drives and refuses the others, so a new entry is a new system's file."""
    from portbench.generator import Traffic
    from portbench.systems import _session, infer, stage1

    mix = {"entry": "emotion_control", "loop": "closed", "clients": 1,
           "samples_per_request": [1, 2], "pool_samples": 4, "warmup_rounds": 1}
    assert {Traffic(mix, 2**31 + 5).request(i).samples for i in range(2)} == {1, 2}
    for system in (infer, stage1):
        with pytest.raises(ValueError, match="emotion_control"):
            _session.check_entry(mix, system.ENTRIES)
    _session.check_entry({"entry": "infer_wav"}, infer.ENTRIES)


def test_paths_hold_only_the_benchmark(bench):
    for p in bench["paths"]:
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch") and p.split("/")[0] not in ("amuse_tpu", "tests",
                                                                     "benchmarks")
    assert Path(bench["command"][1]).parts[0] in bench["paths"]


def test_a_four_card_cell_loads_and_fewer_cards_are_refused(bench, monkeypatch, capsys):
    """A cell on four cards is found by name like any other. ``run.py``
    exits with code 2, and prints no line, where fewer cards are visible:
    each rank looks for the cards, and the launcher, which imports no
    torch, exits as its first failing rank."""
    import torch

    from portbench import run

    four = [w["name"] for w in bench["workloads"] if w["chips"] == 4]
    assert four
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)  # main() sets both
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    for name in four:
        cell = manifest.cell(ROOT, name)
        assert cell.chips == 4 and cell.settings["check"]["limits"]
        assert callable(importlib.import_module(f"portbench.systems.{cell.system}").Session)
        argv = ["--workload", name, "--seed", str(2**31 + 7), "--seconds", "1"]
        with monkeypatch.context() as m:  # a rank of four
            m.setenv("WORLD_SIZE", "4")
            for seen in (0, 1, 3):
                m.setattr(torch.cuda, "is_available", lambda seen=seen: seen > 0)
                m.setattr(torch.cuda, "device_count", lambda seen=seen: seen)
                rc = run.main([*argv, "--launched-at", repr(time.perf_counter())])
                out = capsys.readouterr()
                assert rc == 2 and out.out == "", (seen, out.out)
                assert f"needs 4 CUDA card(s); this process sees {seen}" in out.err
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the launched ranks see no card
        rc = run.main(argv)
        out = capsys.readouterr()
        assert rc == 2 and out.out == "", out.out
        assert "needs 4 CUDA card(s); this process sees 0" in out.err
        assert "every rank has ended" in out.err
