"""The port's launcher side (``amuse_tpu_torch/cluster/jobs.py``) and its CLI
over two CPU ranks.

The render, ledger and local-runner tests and the bring-up trio mirror
``tests/test_cluster.py`` with torch's ``env://`` variables in place of
JAX's. The CLI test launches ``--fn train_gesture`` at tiny widths as two
gloo ranks through ``LocalRunner.submit_multihost`` (a free TCP port from a
bound socket) and holds its logged losses against one process at the same
global batch, dropout 0: rtol 1e-3, the JAX package's bound for its mesh
step after an update (``tests/test_train_steps.py:123``).
"""

import json
import os
import re
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.cluster.jobs import JobLedger, JobSpec, LocalRunner, render_script
from amuse_tpu_torch.data.cache import FIELDS, WindowCache
from amuse_tpu_torch.data.stage1 import load_dataset
from amuse_tpu_torch.parallel import mesh as M
from amuse_tpu_torch.train.checkpoint import CheckpointManager
from tests.torch_port_pipes import write_take

REPO = Path(__file__).resolve().parents[1]


class TestJobs:
    def test_render_script_single_process(self):
        spec = JobSpec("j1", ["python", "-c", "'print(1)'"], env={"A": "b"})
        s = render_script(spec)
        assert "export A='b'" in s
        assert "MASTER_ADDR" not in s and "WORLD_SIZE" not in s
        assert "timeout 28800s" in s and s.startswith("#!/bin/bash")

    def test_render_script_ranks(self):
        """Two hosts of two GPUs: four ranks, LOCAL_RANK the rank on its host."""
        spec = JobSpec("j2", ["train"], num_hosts=2, procs_per_host=2)
        s = render_script(spec, rank=3, master="10.0.0.1:29501")
        for line in ("export MASTER_ADDR=10.0.0.1", "export MASTER_PORT=29501",
                     "export WORLD_SIZE=4", "export RANK=3", "export LOCAL_RANK=1"):
            assert line in s
        with pytest.raises(ValueError, match="outside a world of 4"):
            render_script(spec, rank=4)

    def test_local_runner_and_ledger(self, tmp_path):
        runner = LocalRunner(tmp_path)
        assert runner.submit(JobSpec("ok", ["true"], workdir=str(tmp_path))) == 0
        assert runner.ledger.get("ok")["state"] == "finished"
        assert runner.submit(JobSpec("bad", ["false"], workdir=str(tmp_path))) != 0
        again = JobLedger(tmp_path / "ledger.json")
        assert again.get("bad")["exit_code"] != 0 and set(again.jobs()) == {"ok", "bad"}

    def test_submit_multihost_renders_every_rank(self, tmp_path):
        """Every rank gets its own script and environment, world size 1 too."""
        runner = LocalRunner(tmp_path)
        echo = ["bash", "-c", "'echo $WORLD_SIZE $RANK $LOCAL_RANK $MASTER_ADDR $MASTER_PORT'"]
        for spec, want in ((JobSpec("one", echo, workdir=str(tmp_path)), ["1 0 0 h 7"]),
                           (JobSpec("two", echo, procs_per_host=2, workdir=str(tmp_path)),
                            ["2 0 0 h 7", "2 1 1 h 7"])):
            assert runner.submit_multihost(spec, master="h:7") == [0] * len(want)
            logs = [(tmp_path / f"{spec.name}.r{r}.log").read_text().strip()
                    for r in range(len(want))]
            assert logs == want
            assert all(runner.ledger.get(f"{spec.name}.r{r}")["exit_code"] == 0
                       for r in range(len(want)))


class TestDistributedBringup:
    @staticmethod
    def _fake_init(monkeypatch) -> dict:
        calls = {}

        def fake(backend, init_method, world_size, rank):
            calls.update(backend=backend, init_method=init_method, n=world_size, rank=rank)

        monkeypatch.setattr(torch.distributed, "init_process_group", fake)
        return calls

    def test_initializes_from_cluster_env(self, monkeypatch):
        """The variables the scripts export drive init_process_group (gloo for
        the CPU), and the CLI calls the bring-up before any task."""
        calls = self._fake_init(monkeypatch)
        for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "29500"),
                     ("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "0")):
            monkeypatch.setenv(k, v)
        assert M.initialize_distributed("cpu") == torch.device("cpu")
        assert calls == {"backend": "gloo", "init_method": "env://", "n": 2, "rank": 1}
        monkeypatch.delenv("MASTER_PORT")
        with pytest.raises(ValueError, match="MASTER_PORT"):
            M.initialize_distributed("cpu")
        seen = []
        monkeypatch.setattr(M, "initialize_distributed", lambda d: seen.append(d) or False)
        with pytest.raises(SystemExit):
            cli.main(["--fn", "blender_setup", "--device", "cpu"])
        assert seen == ["cpu"]

    def test_noop_without_env(self, monkeypatch):
        calls = self._fake_init(monkeypatch)
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert M.initialize_distributed("cpu") is False and not calls

    def test_rendered_env_round_trips(self, monkeypatch):
        """render_script's exports parse back into the exact init arguments."""
        script = render_script(JobSpec(name="j", command=["true"], num_hosts=2),
                               rank=1, master="h0:29500")
        for line in script.splitlines():
            m = re.match(r"export (MASTER_\w+|WORLD_SIZE|RANK|LOCAL_RANK)=(.+)", line.strip())
            if m:
                monkeypatch.setenv(m.group(1), m.group(2).strip("'\""))
        calls = self._fake_init(monkeypatch)
        assert M.initialize_distributed("cpu") == torch.device("cpu")
        assert calls == {"backend": "gloo", "init_method": "env://", "n": 2, "rank": 1}
        assert (os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]) == ("h0", "29500")


TINY = {"audio": {"ast_embed_dim": 16, "ast_depth": 1, "ast_heads": 2, "ast_feature_dim": 12},
        "gesture": {"latent_dim": 16, "ff_size": 32, "num_layers": 3, "num_heads": 2,
                    "cond_dim": 12, "num_inference_steps": 3, "epochs": 2, "batch_size": 4,
                    "model_save_freq": 1, "dropout": 0.0},
        "dtype": "float32"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rows(run: Path) -> dict:
    return {r["step"]: r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())}


def test_prepare_and_train_gesture_two_ranks_equal_one_process(tmp_path):
    """``--fn prepare_data`` as 2 gloo ranks writes one process's window cache
    and stage-1 dataset;
    ``--fn train_gesture`` (8 cached windows, global batch 4: 2 rows a rank,
    2 steps an epoch, the DDIM monitor every step) as 2 gloo ranks: one epoch,
    then a resume to two, each launched through ``submit_multihost``. Rank 0
    alone writes one run directory per launch (config, ``metrics.jsonl``, a
    checkpoint per epoch); both ranks resume from it; the logged losses of
    both epochs equal one process's two-epoch run (rtol 1e-3). The single
    process creates no process group."""
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    write_take(root, 2, "scott", "0_9_9", 4, rng)
    write_take(root, 9, "miranda", "0_9_9", 4, rng)
    for actor, name in ((2, "scott"), (9, "miranda")):  # audio only: one stage-1 quad
        write_take(root, actor, name, "0_10_10", 1, rng, motion=False)
    cfg = {**TINY, "out_dir": str(tmp_path / "runs"),
           "data": {"data_root": str(root / "beat"), "mosh_root": str(root / "mosh"),
                    "cache_dir": str(root / "cache"), "stage1_dataset": str(root / "s1.npz"),
                    "smplx_model_dir": str(root / "none")}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    cli.main(["--fn", "prepare_data", "--cfg", str(cfg_path), "--device", "cpu"])

    one_cfg = tmp_path / "one.json"
    one_cfg.write_text(json.dumps({**cfg, "out_dir": str(tmp_path / "one")}))
    cli.main(["--fn", "train_gesture", "--cfg", str(one_cfg), "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    (one,) = (tmp_path / "one").iterdir()
    want = _rows(one)
    assert sorted(want) == [0, 1]

    runner = LocalRunner(tmp_path / "jobs")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}

    def launch(name: str, extra: list, fn: str = "train_gesture") -> list:
        argv = [sys.executable, "-m", "amuse_tpu_torch.cli.main", "--fn", fn,
                "--cfg", str(cfg_path), "--device", "cpu", *extra]
        spec = JobSpec(name, argv, procs_per_host=2, workdir=str(tmp_path))
        rcs = runner.submit_multihost(spec, master=f"localhost:{_free_port()}", env=env)
        logs = [(tmp_path / "jobs" / f"{name}.r{r}.log").read_text() for r in range(2)]
        assert rcs == [0, 0], logs
        return logs

    # prepare_data over the ranks: rank 0 writes the cache the one process wrote
    # (the features within 1e-6: the CPU's GEMMs round by the rows in a call)
    launch("prepare", ["--set", f"data.cache_dir={root / 'cache2'}",
                       "--set", f"data.stage1_dataset={root / 's1_2.npz'}"], "prepare_data")
    one_cache, two_cache = WindowCache(root / "cache"), WindowCache(root / "cache2")
    assert len(one_cache) == len(two_cache) == 8
    # and the stage-1 dataset, byte for byte (each chunk's fbank is computed alone)
    want_s1, got_s1 = (load_dataset(root / n) for n in ("s1.npz", "s1_2.npz"))
    assert want_s1[0]["quad_idx"].shape == (1, 4)  # train: (scott, miranda) neutral
    for want_split, got_split in zip(want_s1, got_s1):
        assert got_split.keys() == want_split.keys()
        for k in want_split:
            np.testing.assert_array_equal(got_split[k], want_split[k], err_msg=k)
    for i in range(8):
        a, b = one_cache[i], two_cache[i]
        for f in FIELDS:
            np.testing.assert_allclose(b[f], a[f], rtol=0,
                                       atol=1e-6 if f in ("con", "emo", "sty") else 0)

    logs = launch("first", ["--set", "gesture.epochs=1"])
    for r, log in enumerate(logs):
        assert f"[distributed] initialized: process {r} of 2, 2 devices total (gloo" in log
        assert "epoch 1/1" in log
    (first,) = (tmp_path / "runs").iterdir()  # rank 0 alone named and wrote it
    assert (first / "experiment_args.json").exists()
    assert CheckpointManager(first / "checkpoints").steps() == [1]

    logs = launch("resumed", ["--set", f"resume={first / 'checkpoints'}"])
    assert all("resumed full train state" in log and "at epoch 1" in log for log in logs)
    runs = sorted((tmp_path / "runs").iterdir())
    assert len(runs) == 2
    resumed = runs[1] if runs[0] == first else runs[0]
    state, meta = CheckpointManager(resumed / "checkpoints").restore()
    assert meta["step"] == 2 and state["step"] == 4  # 2 steps an epoch on every rank
    got = {**_rows(first), **_rows(resumed)}
    assert sorted(got) == [0, 1]
    for epoch in (0, 1):
        keys = [k for k in want[epoch] if k.startswith("train_")]
        assert "train_gen_feature" in keys
        for k in keys:
            assert got[epoch][k] == pytest.approx(want[epoch][k], rel=1e-3), (epoch, k)
