"""Stage-2 window cache: build, read, merge.

Port of ``amuse_tpu/data/cache.py``, with the same on-disk layout, so that
each package's ``WindowCache`` reads the other's cache: sharded directories
``shard_<i>/<field>.npy`` of ``SHARD_WINDOWS`` windows each, and a
``manifest.json`` (``num_windows``, ``shards``, ``fields``, ``ast_source``)
written last. Each take's 10 s audio chunks are encoded by the frozen AST
in one call (``encode_audio_fn``, injected: the CLI passes the port
pipeline's ``encode_audio``); each 300-frame motion window is paired with
its chunk. Shards flush to disk as they fill, so memory stays bounded, and
a finished cache is skipped on a re-run.

Record fields:
  motion (300, 168) f32 | actor_id i32 (0-based) | emo_label i32 |
  audio (160000,) f32 | con / emo / sty (feature_dim,) f32
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from amuse_tpu_torch.audio import fbank as fbank_mod
from amuse_tpu_torch.audio.wavio import load_wav_resampled
from amuse_tpu_torch.data import beat as beat_mod
from amuse_tpu_torch.data.actors import ACTORS, subject_to_gender_beta

SHARD_WINDOWS = 256  # windows per shard

FIELDS = ("motion", "actor_id", "emo_label", "audio", "con", "emo", "sty")


def build_stage2_cache(
    takes: Sequence[beat_mod.Take],
    out_dir: Path,
    encode_audio_fn,  # (N, 160000) f32 -> {"con", "emo", "sty"} (N, feature_dim)
    window_frames: int = 300,
    progress: bool = True,
    ast_source: str = "",
) -> Path:
    """Build the stage-2 window cache from MoSh takes and frozen-AST features."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest_path = out_dir / "manifest.json"
    if manifest_path.exists():
        # the cached features are a function of the AST weights: a cache built
        # from other weights (random ones, before a checkpoint was configured)
        # must not be reused, or the denoiser trains on the wrong conditioning
        stored = json.loads(manifest_path.read_text()).get("ast_source")
        if stored is not None and ast_source and stored != ast_source:
            raise RuntimeError(
                f"stage-2 cache at {out_dir} was built with AST weights '{stored}' but "
                f"the current run uses '{ast_source}'; delete {out_dir} to rebuild "
                "with the right features"
            )
        return out_dir

    records: dict[str, list] = {f: [] for f in FIELDS}
    shards: list[str] = []
    n = 0  # windows written and buffered

    def flush(final: bool) -> None:
        """Write every full group of SHARD_WINDOWS (all of the buffer when
        final): one window is ~850 KB, so a whole BEAT build held in memory
        would take many GB."""
        nonlocal records
        while records["motion"] and (final or len(records["motion"]) >= SHARD_WINDOWS):
            shard_dir = out_dir / f"shard_{len(shards):05d}"
            shard_dir.mkdir(exist_ok=True)
            for f in FIELDS:
                np.save(shard_dir / f"{f}.npy", np.stack(records[f][:SHARD_WINDOWS]))
            shards.append(shard_dir.name)
            records = {f: records[f][SHARD_WINDOWS:] for f in FIELDS}

    for t in takes:
        motion = beat_mod.load_mosh_motion(t.mosh_npz)
        wave = load_wav_resampled(t.wav)
        if wave.shape[-1] < fbank_mod.CHUNK_SAMPLES:  # one short wav must not abort the build
            print(f"[cache] {t.actor_name}/{t.take}: wav shorter than one 10 s chunk "
                  f"({wave.shape[-1]} samples); skipped")
            continue
        chunks = fbank_mod.window_waveform(wave)
        cond = encode_audio_fn(chunks.astype(np.float32))
        con, emo, sty = (np.asarray(cond[k]) for k in ("con", "emo", "sty"))
        emo_label = beat_mod.emotion_label(t.emotion_csv) if t.emotion_csv else 0
        n_windows = min(motion.shape[0] // window_frames, con.shape[0])
        for w in range(n_windows):
            records["motion"].append(motion[w * window_frames:(w + 1) * window_frames])
            records["actor_id"].append(t.actor_id - 1)  # 0-based labels
            records["emo_label"].append(emo_label)
            records["audio"].append(chunks[w])
            records["con"].append(con[w])
            records["emo"].append(emo[w])
            records["sty"].append(sty[w])
        n += n_windows
        flush(final=False)
        if progress:
            print(f"[cache] {t.actor_name}/{t.take}: {n_windows} windows")

    if n == 0:
        # no 0-window manifest: the skip-if-built check would then
        # short-circuit every rebuild after the data is fixed
        print(f"[cache] no windows produced from {len(takes)} takes; manifest NOT "
              "written (fix data and re-run)")
        return out_dir
    flush(final=True)
    manifest_path.write_text(json.dumps(
        {"num_windows": n, "shards": shards, "fields": list(FIELDS), "ast_source": ast_source},
        indent=1,
    ))
    if progress:
        print(f"[cache] wrote {n} windows in {len(shards)} shards -> {out_dir}")
    return out_dir


class WindowCache:
    """Memory-mapped read side of the stage-2 cache. Shards are directories
    of per-field .npy opened with ``mmap_mode="r"``; compressed-npz shards of
    older caches load into memory."""

    def __init__(self, cache_dir):
        self.dir = Path(cache_dir)
        manifest = json.loads((self.dir / "manifest.json").read_text())
        self.num_windows = manifest["num_windows"]
        self._shards = [self._open(s) for s in manifest["shards"]]
        self._starts = np.cumsum([0] + [s["actor_id"].shape[0] for s in self._shards])

    def _open(self, name: str):
        p = self.dir / name
        if p.is_dir():
            return {f: np.load(p / f"{f}.npy", mmap_mode="r") for f in FIELDS}
        return np.load(p)  # an older .npz shard

    def __len__(self):
        return self.num_windows

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        s = int(np.searchsorted(self._starts, idx, "right") - 1)
        o = idx - self._starts[s]
        return {f: self._shards[s][f][o] for f in FIELDS}

    def batches(self, batch_size: int, rng: Optional[np.random.Generator] = None,
                drop_remainder: bool = True,
                include_audio: bool = False) -> Iterator[dict[str, np.ndarray]]:
        """An epoch of stacked batches {"motion", "actor_id", "emo_label",
        "con", "emo", "sty"[, "audio"]}, shuffled when ``rng`` is given."""
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        fields = [f for f in FIELDS if include_audio or f != "audio"]
        for i in range(0, len(order) - (batch_size - 1 if drop_remainder else 0), batch_size):
            idx = order[i:i + batch_size]
            if drop_remainder and len(idx) < batch_size:
                break
            items = [self[int(j)] for j in idx]
            yield {f: np.stack([it[f] for it in items]) for f in fields}


def merge_caches(cache_dirs, out_dir) -> Path:
    """Merge several window caches into one under ``out_dir`` (per-host
    builds into one cache), re-manifesting their shards.

    Every manifest is read and the sources' AST weights checked to agree
    before any shard moves; an ``out_dir`` that is itself a source is safe,
    because copies are staged under temporary names first.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    manifests, sources = [], set()
    for d in cache_dirs:
        d = Path(d)
        manifest = json.loads((d / "manifest.json").read_text())
        sources.add(manifest.get("ast_source", ""))
        manifests.append((d, manifest))
    if len(sources) > 1:
        raise RuntimeError(
            f"refusing to merge caches built from DIFFERENT AST weights: {sorted(sources)} "
            "- their con/emo/sty features are incompatible"
        )
    shards, total, staged = [], 0, []  # staged: (temporary name, final name)
    for d, manifest in manifests:
        for s in manifest["shards"]:
            src = d / s
            suffix = "" if src.is_dir() else ".npz"
            name = f"shard_{len(shards):05d}{suffix}"
            if src.resolve() != (out_dir / name).resolve():
                tmp = f".merge_{len(shards):05d}{suffix}"
                if src.is_dir():
                    shutil.copytree(src, out_dir / tmp, dirs_exist_ok=True)
                else:
                    shutil.copyfile(src, out_dir / tmp)
                staged.append((tmp, name))
            shards.append(name)
        total += manifest["num_windows"]
    for tmp, name in staged:
        dst = out_dir / name
        if dst.exists():  # a displaced destination shard, already staged above
            shutil.rmtree(dst) if dst.is_dir() else dst.unlink()
        (out_dir / tmp).rename(dst)
    (out_dir / "manifest.json").write_text(json.dumps(
        {"num_windows": total, "shards": shards, "fields": list(FIELDS),
         # the provenance keeps build_stage2_cache's weights check working
         "ast_source": next(iter(sources), "")},
        indent=1,
    ))
    return out_dir


def betas_for_actor_ids(actor_ids: np.ndarray) -> np.ndarray:
    """(B,) 0-based actor ids -> (B, 300) float32 betas from the actor table."""
    names = [ACTORS[int(i) + 1].name for i in actor_ids]
    return np.stack([subject_to_gender_beta(n)[1] for n in names]).astype(np.float32)
