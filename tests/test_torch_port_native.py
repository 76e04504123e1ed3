"""The port's native ABIN loader (``native/loader.py``) and the CLI tasks of
the evaluation slice against the JAX package (CPU).

The loader: each package's ABIN file reads identically in the other, the
same seed gives both packages the same shuffled batches (both compile the
same ``std::mt19937_64`` shuffle), and a failed build raises. The CLI:
``--fn train_gesture`` with ``gesture.native_loader=true`` trains and
resumes step-identically; ``--fn eval_gesture`` refuses as the JAX package
does (its report's keys: tests/test_torch_port_eval.py); ``--fn
train_embedder`` runs with ``--device cpu`` on a tiny synthetic tree and
writes an ``embedder.npz`` that the JAX package reads and that matches its
own training from the same initial weights (parameters within 1e-4, the
losses of 2 epochs of 2 Adam steps in float32).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from amuse_tpu import native as jnative
from amuse_tpu.cli import main as jcli
from amuse_tpu.eval import embedder as jemb
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.data.cache import WindowCache
from amuse_tpu_torch.data.prefetch import prefetch_to_device
from amuse_tpu_torch.eval import embedder as temb
from amuse_tpu_torch.native import loader
from tests.torch_port_pipes import write_take

TINY = {"audio": {"ast_embed_dim": 16, "ast_depth": 1, "ast_heads": 2, "ast_feature_dim": 12},
        "gesture": {"latent_dim": 16, "ff_size": 32, "num_layers": 3, "num_heads": 2,
                    "cond_dim": 12, "num_inference_steps": 3, "epochs": 1, "batch_size": 4,
                    "vtex_displacement": False, "model_save_freq": 1},
        "embedder": {"epochs": 2, "batch_size": 4, "channels": [16, 8], "latent_dim": 8},
        "dtype": "float32"}


def records(n: int = 21) -> dict:
    rng = np.random.default_rng(0)
    return {"motion": rng.normal(size=(n, 6, 8)).astype(np.float32),
            "label": np.arange(n, dtype=np.int32),
            "feat": rng.normal(size=(n, 4)).astype(np.float32)}


class TestLoader:
    def test_builds_and_round_trips(self, tmp_path):
        """The library builds (hash-named under build/amuse_tpu_torch); an
        unshuffled epoch returns the records in order, the remainder dropped,
        and a shuffled one keeps every record's fields together."""
        lib = loader.build()
        assert lib.exists() and lib.parent == loader.BUILD_DIR
        assert lib.name.startswith("libamuse_io-")
        rec = records()
        ld = loader.NativeWindowLoader(loader.write_abin(tmp_path / "c.abin", rec))
        assert len(ld) == 21 and [f[0] for f in ld.fields] == ["motion", "label", "feat"]
        assert ld.fields[0][2] == (6, 8) and ld.fields[1][1] == np.int32
        batches = list(ld.epoch(4, shuffle=False))
        assert len(batches) == 5
        np.testing.assert_array_equal(np.concatenate([b["motion"] for b in batches]),
                                      rec["motion"][:20])
        for b in ld.epoch(5, seed=3):
            for i, lbl in enumerate(b["label"]):
                np.testing.assert_array_equal(b["feat"][i], rec["feat"][lbl])
        ld.close()
        with pytest.raises(FileNotFoundError):
            loader.NativeWindowLoader(tmp_path / "missing.abin")

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_files_read_identically_in_both(self, tmp_path, writer):
        rec = records()
        path = tmp_path / "c.abin"
        (loader.write_abin if writer == "port" else jnative.write_abin)(path, rec)
        other = tmp_path / "other.abin"
        (jnative.write_abin if writer == "port" else loader.write_abin)(other, rec)
        assert path.read_bytes() == other.read_bytes()
        mine, theirs = loader.NativeWindowLoader(path), jnative.NativeWindowLoader(path)
        assert mine.fields == theirs.fields
        for a, b in zip(mine.epoch(4, shuffle=False), theirs.epoch(4, shuffle=False)):
            for k in rec:
                np.testing.assert_array_equal(a[k], b[k])

    @pytest.mark.parametrize("seed", [0, 7, 2021 * 100_003 + 1])
    def test_shuffled_epochs_match_jax(self, tmp_path, seed):
        path = loader.write_abin(tmp_path / "c.abin", records())
        mine = [b["label"] for b in loader.NativeWindowLoader(path).epoch(4, seed=seed)]
        theirs = [b["label"] for b in jnative.NativeWindowLoader(path).epoch(4, seed=seed)]
        assert len(mine) == 5 and sorted(np.concatenate(mine).tolist()) != list(range(20))
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)

    def test_prefetched_batches_are_copies(self, tmp_path):
        """Batches handed to the prefetch thread stay intact while the loader
        refills its buffer (each is copied out of it)."""
        rec = records(64)
        ld = loader.NativeWindowLoader(loader.write_abin(tmp_path / "c.abin", rec))
        got = list(prefetch_to_device(ld.epoch(2, seed=1, prefetch=2), size=8, device="cpu"))
        want = list(ld.epoch(2, seed=1))
        assert len(got) == 32
        for a, b in zip(got, want):
            assert torch.equal(a["motion"], torch.from_numpy(b["motion"]))
            np.testing.assert_array_equal(a["motion"].numpy(), rec["motion"][b["label"]])

    def test_a_new_epoch_ends_the_abandoned_one(self, tmp_path):
        """Starting an epoch while an earlier one is unfinished (as a prefetch
        producer abandoned mid-epoch leaves it) ends the earlier generator:
        it yields nothing more and steals no batch of the new epoch, which
        equals a fresh one; twenty epochs abandoned through the prefetch
        thread leave the next whole epoch intact; closing the loader right
        after abandoning an epoch is safe, and a closed loader refuses."""
        rec = records(64)
        ld = loader.NativeWindowLoader(loader.write_abin(tmp_path / "c.abin", rec))
        old = ld.epoch(4, seed=1)
        next(old)
        new = ld.epoch(4, seed=2)
        got = [next(new)]
        assert list(old) == []
        got += list(new)
        want = list(ld.epoch(4, seed=2))
        assert len(got) == len(want) == 16
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["label"], b["label"])
        for i in range(20):
            feed = prefetch_to_device(ld.epoch(4, seed=i), size=2, device="cpu")
            for _ in range(1 + i % 5):
                next(feed)
            feed.close()
        full = list(prefetch_to_device(ld.epoch(4, seed=99), size=2, device="cpu"))
        assert len(full) == 16
        labels = torch.cat([b["label"] for b in full]).numpy()
        assert sorted(labels.tolist()) == list(range(64))
        for b in full:
            np.testing.assert_array_equal(b["motion"].numpy(), rec["motion"][b["label"].numpy()])
        feed = prefetch_to_device(ld.epoch(4, seed=5), size=2, device="cpu")
        next(feed)
        feed.close()
        ld.close()  # at once: the producer may still be fetching a batch
        with pytest.raises(ValueError, match="closed"):
            next(ld.epoch(4))

    def test_failed_build_raises(self, tmp_path, monkeypatch):
        broken = tmp_path / "amuse_io.cc"
        broken.write_text("this is not C++\n")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            loader.build(broken)
        monkeypatch.setattr(loader, "SRC", broken)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            loader.NativeWindowLoader(tmp_path / "any.abin")
        monkeypatch.setenv("PATH", str(tmp_path))  # no compiler on the path
        broken.write_text("int x;\n")
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            loader.build(broken)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 actors x 1 take x 4 windows and the stage-2 cache built by the
    port's prepare_data."""
    root = tmp_path_factory.mktemp("native_cli")
    rng = np.random.default_rng(0)
    write_take(root, 2, "scott", "0_9_9", 4, rng)
    write_take(root, 9, "miranda", "0_9_9", 4, rng)
    cli.main(["--fn", "prepare_data", "--cfg", _cfg(root, root / "prep"), "--device", "cpu"])
    return root


def _cfg(root, work, gesture: dict = None, data: dict = None, **top) -> str:
    work.mkdir(parents=True, exist_ok=True)
    cfg = {**TINY, "out_dir": str(work / "runs"), **top,
           "gesture": {**TINY["gesture"], **(gesture or {})},
           "data": {"data_root": str(root / "beat"), "mosh_root": str(root / "mosh"),
                    "cache_dir": str(root / "cache"), "stage1_dataset": str(work / "s1.npz"),
                    "smplx_model_dir": str(root / "nowhere"), **(data or {})}}
    (work / "cfg.json").write_text(json.dumps(cfg))
    return str(work / "cfg.json")


def _train(root, work, epochs: int, resume: str = "") -> tuple:
    argv = ["--fn", "train_gesture", "--device", "cpu",
            "--cfg", _cfg(root, work, {"epochs": epochs, "native_loader": True})]
    cli.main(argv + (["--set", f"resume={resume}"] if resume else []))
    run = sorted((work / "runs").iterdir())[-1]
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return run, {r["step"]: r for r in rows}


class TestCli:
    def test_train_gesture_native_loader_resumes(self, tree, tmp_path, capsys):
        """train.abin is built beside the cache (and rebuilt when the manifest
        is newer); its batches are the JAX package's for the seed; a run of
        one epoch resumed to two logs the unbroken run's epoch 2 (rtol 1e-6)."""
        abin = tree / "cache" / "train.abin"
        abin.unlink(missing_ok=True)
        _, rows = _train(tree, tmp_path / "full", 2)
        assert "native ABIN loader: 8 windows" in capsys.readouterr().out
        assert sorted(rows) == [0, 1] and all(np.isfinite(v) for v in rows[1].values())
        ld = loader.NativeWindowLoader(abin)
        assert [f[0] for f in ld.fields] == ["motion", "actor_id", "con", "emo", "sty"]
        wc = WindowCache(tree / "cache")
        for b, jb in zip(ld.epoch(4, seed=2021 * 100_003),
                         jnative.NativeWindowLoader(abin).epoch(4, seed=2021 * 100_003)):
            np.testing.assert_array_equal(b["con"], jb["con"])
            i = int(np.flatnonzero([np.array_equal(wc[k]["con"], b["con"][0])
                                    for k in range(len(wc))])[0])
            np.testing.assert_array_equal(b["motion"][0], wc[i]["motion"])
        ld.close()
        stale = abin.stat().st_mtime - 3600  # older than the manifest: rebuilt
        os.utime(abin, (stale, stale))
        part, _ = _train(tree, tmp_path / "part", 1)
        assert abin.stat().st_mtime > stale
        _, resumed = _train(tree, tmp_path / "resumed", 2, str(part / "checkpoints"))
        assert sorted(resumed) == [1]
        for k, v in rows[1].items():
            if k.startswith("train_"):
                assert resumed[1][k] == pytest.approx(v, rel=1e-6), k

    def test_native_build_failure_is_not_a_fallback(self, tree, tmp_path, monkeypatch):
        broken = tmp_path / "amuse_io.cc"
        broken.write_text("not C++\n")
        monkeypatch.setattr(loader, "SRC", broken)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _train(tree, tmp_path / "t", 1)

    def test_eval_gesture_refusals_match_jax(self, tree, tmp_path, capsys):
        """Strict position space without a body model, and a configured
        embedder path that does not exist: SystemExit in both packages, before
        any model is built; a missing default embedder is only omitted."""
        for kw, match in (({"test": {"strict_position_space": True}}, "rotation-space"),
                          ({"data": {"embedder_path": str(tmp_path / "nope.npz")}},
                           "does not exist")):
            cfg = _cfg(tree, tmp_path / match[:4], data=kw.get("data"),
                       **{k: v for k, v in kw.items() if k != "data"})
            with pytest.raises(SystemExit, match=match):
                cli.main(["--fn", "eval_gesture", "--cfg", cfg, "--device", "cpu"])
            with pytest.raises(SystemExit, match=match):
                jcli.main(["--fn", "eval_gesture", "--cfg", cfg])
            assert "[pipeline]" not in capsys.readouterr().out

    def test_eval_without_default_embedder(self, tree, tmp_path, monkeypatch, capsys):
        monkeypatch.setattr(temb, "DEFAULT_WEIGHTS", tmp_path / "absent.npz")
        cli.main(["--fn", "eval_gesture", "--device", "cpu",
                  "--cfg", _cfg(tree, tmp_path / "e", debug=True)])
        out = capsys.readouterr().out
        assert "fgd_embedder omitted" in out and '"fgd_embedder"' not in out
        assert "rotation" in out and not (tmp_path / "e" / "runs").exists()

    def test_train_embedder_matches_jax_and_loads_there(self, tree, tmp_path, monkeypatch,
                                                        capsys):
        """Both packages train from the same initial weights (JAX's draw,
        injected into the port): the same epoch losses (rel 1e-5) and
        parameters (1e-4) in embedder.npz, the same provenance; JAX's
        ``embedder.load`` reads the port's file."""
        flat = {}

        def jax_init(seed, cfg):
            jp = jemb.init_params(jax.random.key(seed), jemb.EmbedderConfig(
                in_dim=cfg.in_dim, window=cfg.window, channels=cfg.channels,
                latent_dim=cfg.latent_dim))
            flat.update({"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]})
            return {k: torch.from_numpy(v.copy()) for k, v in flat.items()}

        monkeypatch.setattr(temb, "init_params", jax_init)
        cli.main(["--fn", "train_embedder", "--device", "cpu",
                  "--cfg", _cfg(tree, tmp_path / "port")])
        port_out = capsys.readouterr().out
        jcli.main(["--fn", "train_embedder", "--cfg", _cfg(tree, tmp_path / "jax")])
        jax_out = capsys.readouterr().out

        def losses(out):
            return [float(line.rsplit("recon=", 1)[1]) for line in out.splitlines()
                    if line.startswith("[embedder] epoch")]

        assert len(losses(port_out)) == 2
        np.testing.assert_allclose(losses(port_out), losses(jax_out), rtol=1e-5)
        (port,), (jax_,) = ((tmp_path / w / "runs").glob("*/embedder.npz")
                            for w in ("port", "jax"))
        jp, jcfg, jprov = jemb.load(port)
        want, wcfg, wprov = jemb.load(jax_)
        assert jcfg == wcfg and jprov == wprov and "8 windows), 2 epochs, seed 2021" in jprov
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            got = jp
            for part in key.split("/"):
                got = got[part]
            np.testing.assert_allclose(np.asarray(got), np.asarray(v), rtol=1e-4, atol=1e-4,
                                       err_msg=key)
        assert not np.array_equal(np.asarray(want["enc16"]["kernel"]), flat["enc16/kernel"])
