"""The port's data builders (data/cache.py, data/stage1.py) and ``--fn
prepare_data`` against the JAX package, on the CPU.

Both packages build from one synthetic BEAT tree with the same AST weights
(``tests/torch_port_pipes.py``, float32): the stage-2 caches have equal
manifests, bit-equal motion, audio and labels, features within atol 1e-4,
and each package's ``WindowCache`` reads the other's; the stage-1 fbank
banks agree within 1e-4 (the port's fbank bound on random audio,
``test_torch_port_core.py``) with equal quads and labels.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.cli import main as jcli
from amuse_tpu.cli.config import load_config as jload_config
from amuse_tpu.data import beat as jbeat
from amuse_tpu.data import cache as jcache
from amuse_tpu.data import stage1 as jstage1
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.data import beat, cache, stage1
from tests.torch_port_pipes import FEAT_ATOL, make_pipes, write_take

FBANK_ATOL = 1e-4
LABELS = ("motion", "actor_id", "emo_label", "audio")


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two stage-2 actors and two validation actors (nidal, li; not stage-2
    actors), the two neutral takes each at 2 windows, and a stage-2 take
    shorter than one chunk."""
    root = tmp_path_factory.mktemp("beat_tree")
    rng = np.random.default_rng(4)
    for actor_id, name in ((2, "scott"), (9, "miranda"), (11, "nidal"), (20, "li")):
        for take in ("0_9_9", "0_10_10"):
            write_take(root, actor_id, name, take, 2, rng)
    write_take(root, 2, "scott", "0_65_65", 0, rng, extra_samples=5000)
    return root


def _encoders(pipes):
    """{package: encode_audio_fn}: (N, 160000) chunks -> numpy features."""
    jpipe, port = pipes
    return {"jax": lambda c: {k: np.asarray(v)
                              for k, v in jpipe.encode_audio(jnp.asarray(c)).items()},
            "port": lambda c: {k: v.numpy() for k, v in port.encode_audio(c).items()}}


@pytest.fixture(scope="module")
def caches(pipes, tree, tmp_path_factory):
    """The stage-2 cache of ``tree`` built by each package -> {package: dir}."""
    out = tmp_path_factory.mktemp("caches")
    enc = _encoders(pipes)
    jbuild = jcache.build_stage2_cache(
        jbeat.stage2_subset(jbeat.discover(tree / "beat", tree / "mosh")), out / "jax",
        enc["jax"], ast_source="w")
    build = cache.build_stage2_cache(
        beat.stage2_subset(beat.discover(tree / "beat", tree / "mosh")), out / "port",
        enc["port"], ast_source="w")
    return {"jax": jbuild, "port": build}


def assert_caches_match(got: Path, want: Path) -> None:
    manifest = json.loads((got / "manifest.json").read_text())
    assert manifest == json.loads((want / "manifest.json").read_text())
    for shard in manifest["shards"]:
        for f in cache.FIELDS:
            a, b = np.load(got / shard / f"{f}.npy"), np.load(want / shard / f"{f}.npy")
            assert a.dtype == b.dtype and a.shape == b.shape, f
            if f in LABELS:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, atol=FEAT_ATOL, rtol=1e-3)


def test_stage2_cache_matches_jax(caches):
    assert_caches_match(caches["port"], caches["jax"])
    manifest = json.loads((caches["port"] / "manifest.json").read_text())
    assert manifest["num_windows"] == 8 and manifest["ast_source"] == "w"


@pytest.mark.parametrize("reader", ["port_reads_jax", "jax_reads_port"])
def test_window_cache_reads_the_other_package(caches, reader):
    src, read, other = ((caches["jax"], cache.WindowCache, jcache.WindowCache)
                        if reader == "port_reads_jax"
                        else (caches["port"], jcache.WindowCache, cache.WindowCache))
    wc, ref = read(src), other(src)
    assert len(wc) == len(ref) == 8
    for i in (0, 5, 7):
        for f in cache.FIELDS:
            np.testing.assert_array_equal(wc[i][f], ref[i][f])
    batches = list(wc.batches(3, np.random.default_rng(0), include_audio=True))
    want = list(ref.batches(3, np.random.default_rng(0), include_audio=True))
    assert len(batches) == len(want) == 2
    for b, w in zip(batches, want):
        assert b.keys() == w.keys()
        for k in b:
            np.testing.assert_array_equal(b[k], w[k])


def test_shard_flush_matches_jax(pipes, tree, tmp_path, monkeypatch):
    """Shards of SHARD_WINDOWS windows flush as they fill: 8 windows at 3 per
    shard -> 3 shards, laid out as the JAX package lays them out."""
    monkeypatch.setattr(cache, "SHARD_WINDOWS", 3)
    monkeypatch.setattr(jcache, "SHARD_WINDOWS", 3)
    enc = _encoders(pipes)
    subset = beat.stage2_subset(beat.discover(tree / "beat", tree / "mosh"))
    jsubset = jbeat.stage2_subset(jbeat.discover(tree / "beat", tree / "mosh"))
    got = cache.build_stage2_cache(subset, tmp_path / "p", enc["port"], progress=False)
    want = jcache.build_stage2_cache(jsubset, tmp_path / "j", enc["jax"], progress=False)
    assert json.loads((got / "manifest.json").read_text())["shards"] == [
        "shard_00000", "shard_00001", "shard_00002"]
    assert_caches_match(got, want)


@pytest.mark.parametrize("case", ["skip_when_built", "refuse_other_weights",
                                  "no_zero_window_manifest"])
def test_stage2_cache_guards(caches, tree, tmp_path, case, capsys):
    def never(chunks):
        raise AssertionError("a built cache encoded again")

    subset = beat.stage2_subset(beat.discover(tree / "beat", tree / "mosh"))
    if case == "skip_when_built":
        assert cache.build_stage2_cache(subset, caches["port"], never, ast_source="w") \
            == caches["port"]
        assert capsys.readouterr().out == ""
    elif case == "refuse_other_weights":
        with pytest.raises(RuntimeError, match="built with AST weights 'w'"):
            cache.build_stage2_cache(subset, caches["jax"], never, ast_source="other")
    else:
        short = [t for t in subset if t.take == "0_65_65"]
        cache.build_stage2_cache(short, tmp_path / "c", never)
        assert "wav shorter than one 10 s chunk" in capsys.readouterr().out
        assert not (tmp_path / "c" / "manifest.json").exists()


def _mini_cache(tmp_path, name, n, seed):
    """tests/test_data_review_regressions.py's tiny valid cache."""
    rng = np.random.default_rng(seed)
    d = tmp_path / name
    (d / "shard_00000").mkdir(parents=True)
    cols = {"motion": rng.normal(size=(n, 12, 168)).astype(np.float32),
            "actor_id": np.arange(n, dtype=np.int32) + seed * 100,
            "emo_label": np.zeros(n, np.int32),
            "audio": rng.normal(size=(n, 100)).astype(np.float32),
            "con": rng.normal(size=(n, 8)).astype(np.float32),
            "emo": rng.normal(size=(n, 8)).astype(np.float32),
            "sty": rng.normal(size=(n, 8)).astype(np.float32)}
    for f, a in cols.items():
        np.save(d / "shard_00000" / f"{f}.npy", a)
    (d / "manifest.json").write_text(json.dumps(
        {"num_windows": n, "shards": ["shard_00000"], "fields": list(cache.FIELDS),
         "ast_source": "w"}))
    return d


@pytest.mark.parametrize("case", ["fresh_dir", "in_place", "refuse_other_weights",
                                  "jax_and_port_caches"])
def test_merge_caches(caches, tmp_path, case):
    """tests/test_data_review_regressions.py's merge cases on the port, and a
    merge of a JAX-built with a port-built cache."""
    if case == "jax_and_port_caches":
        out = cache.merge_caches([caches["jax"], caches["port"]], tmp_path / "out")
        wc = cache.WindowCache(out)
        assert len(wc) == 16 and len(jcache.WindowCache(out)) == 16
        np.testing.assert_array_equal(wc[8]["motion"],
                                      cache.WindowCache(caches["port"])[0]["motion"])
        return
    a, b = _mini_cache(tmp_path, "a", 3, 1), _mini_cache(tmp_path, "b", 2, 2)
    if case == "refuse_other_weights":
        mb = json.loads((b / "manifest.json").read_text())
        mb["ast_source"] = "OTHER"
        (b / "manifest.json").write_text(json.dumps(mb))
        with pytest.raises(RuntimeError, match="DIFFERENT AST weights"):
            cache.merge_caches([a, b], tmp_path / "out")
        assert not any((tmp_path / "out").glob("shard_*"))
        return
    out = cache.merge_caches([a, b], tmp_path / "out" if case == "fresh_dir" else b)
    wc = cache.WindowCache(out)
    assert len(wc) == 5
    assert sorted(int(wc[i]["actor_id"]) for i in range(5)) == [100, 101, 102, 200, 201]


def test_betas_for_actor_ids_match_jax():
    ids = np.array([0, 1, 8, 29])
    np.testing.assert_array_equal(cache.betas_for_actor_ids(ids), jcache.betas_for_actor_ids(ids))


def test_stage1_quads_match_jax(tree):
    takes = beat.discover(tree / "beat", tree / "mosh")
    jtakes = jbeat.discover(tree / "beat", tree / "mosh")
    assert stage1.takes_provenance(takes) == jstage1.takes_provenance(jtakes)
    per_take = stage1.fbanks_per_take(takes, stage1.device_fbank_fn("cpu"))
    jper_take = jstage1.fbanks_per_take(jtakes)
    assert per_take.keys() == jper_take.keys() and len(per_take) == 8  # the short wav is left out
    for split, n in (("train", 2), ("val", 2)):
        got, want = stage1.build_quads(per_take, split), jstage1.build_quads(jper_take, split)
        assert got.keys() == want.keys() and got["emo_id"].shape == (n,)
        for k in got:
            if k == "fbank_bank":
                np.testing.assert_allclose(got[k], want[k], atol=FBANK_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


def test_cli_prepare_data_matches_jax(pipes, tree, tmp_path, monkeypatch, capsys):
    """``--fn prepare_data --device cpu`` against the JAX CLI on the same AST
    weights (``_make_pipeline`` of each returns the module's pipelines): the
    same cache and stage-1 dataset; a re-run writes nothing new; an empty data
    root writes nothing; without ``--device cpu`` and a GPU it raises."""
    jpipe, port = pipes
    monkeypatch.setattr(jcli, "_make_pipeline", lambda cfg: jpipe)
    monkeypatch.setattr(cli, "_make_pipeline", lambda cfg, device: port)
    monkeypatch.delenv("AMUSE_TPU_CKPT", raising=False)

    def cfg(name: str, data_root=tree / "beat") -> dict:
        return {"data": {"data_root": str(data_root), "mosh_root": str(tree / "mosh"),
                         "cache_dir": str(tmp_path / name / "cache"),
                         "stage1_dataset": str(tmp_path / name / "stage1.npz")}}

    jcli.task_prepare_data(jload_config(None, cfg("jax")))
    (tmp_path / "port.json").write_text(json.dumps(cfg("port")))
    argv = ["--fn", "prepare_data", "--cfg", str(tmp_path / "port.json"), "--device", "cpu"]
    capsys.readouterr()
    cli.main(argv)
    out = capsys.readouterr().out
    assert "[cache] wrote 8 windows in 1 shards" in out
    assert "stage-1 quads: train 2, val 2" in out
    assert_caches_match(tmp_path / "port" / "cache", tmp_path / "jax" / "cache")
    (got, gval), (want, wval) = (stage1.load_dataset(tmp_path / p / "stage1.npz")
                                 for p in ("port", "jax"))
    for a, b in ((got, want), (gval, wval)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=FBANK_ATOL, rtol=0)
    mtime = (tmp_path / "port" / "stage1.npz").stat().st_mtime_ns
    cli.main(argv)
    out = capsys.readouterr().out
    assert "[cache]" not in out and "stage-1 dataset current, skipping" in out
    assert (tmp_path / "port" / "stage1.npz").stat().st_mtime_ns == mtime
    (tmp_path / "empty.json").write_text(json.dumps(cfg("empty", tmp_path / "nowhere")))
    cli.main(["--fn", "prepare_data", "--cfg", str(tmp_path / "empty.json"), "--device", "cpu"])
    assert "not writing empty datasets" in capsys.readouterr().out
    assert not (tmp_path / "empty").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--fn", "prepare_data", "--cfg", str(tmp_path / "port.json")])
