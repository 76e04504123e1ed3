"""Stage-1 dataset: (actor1, actor2) x (take1, take2) fbank quads.

Port of ``amuse_tpu/data/stage1.py``. ``fbanks_per_take`` turns each take's
10 s chunks into normalised Kaldi fbanks (one batched call per take, on the
device the caller's ``fbank_fn`` uses); ``build_quads`` pairs all
2-combinations of the split's actors x the two recorded takes of each
emotion x the common chunk count, with the reference's validation actors
{nidal, li, kexin} and dropped actors {yingqing, goto}. The npz layout is
the JAX package's, read and written byte for byte the same: each take's
fbank chunks once in ``fbank_bank`` (M, 1024, 128) with ``quad_idx`` (N, 4)
indices into it, 0-based ``emo_id``, ``a1_id``, ``a2_id`` labels, and a
``__meta__`` provenance record; ``batches`` gathers the quads at batch time.
A data-parallel run maps the arrays from one unpacked copy per host in a
directory of the run (``load_dataset``).
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import tempfile
import zipfile
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from amuse_tpu_torch.audio import fbank as fb
from amuse_tpu_torch.audio.wavio import load_wav_resampled
from amuse_tpu_torch.data import beat as beat_mod
from amuse_tpu_torch.data.actors import (
    ACTORS,
    EMOTIONS,
    PRETRAINED_TAKES,
    STAGE1_DROPPED_ACTORS,
    STAGE1_VAL_ACTORS,
)


def fbanks_per_take(takes: Sequence[beat_mod.Take],
                    fbank_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                    ) -> dict[tuple[int, str], dict]:
    """{(actor_id, take): {"fbanks": (C, 1024, 128), "emo": int}}, one
    ``fbank_fn`` call per take (default: ``make_sharded_fbank(None, "cuda")``,
    one call on the card). Takes without a wav or shorter than one 10 s chunk
    are left out: full-chunk windowing and the fixed 1024-frame padding leave
    no shorter chunk to drop."""
    fbank_fn = fbank_fn or fb.make_sharded_fbank(None, "cuda")
    out = {}
    for t in takes:
        if t.wav is None:
            continue
        wave = load_wav_resampled(t.wav)
        if wave.shape[-1] < fb.CHUNK_SAMPLES:
            continue
        fbanks = fbank_fn(fb.window_waveform(wave).astype(np.float32))
        emo = beat_mod.emotion_label(t.emotion_csv) if t.emotion_csv else 0
        out[(t.actor_id, t.take)] = {"fbanks": fbanks, "emo": emo}
    return out


def build_quads(per_take: dict[tuple[int, str], dict],
                split: str = "train") -> dict[str, np.ndarray]:
    """Quad records of one split, each take's chunks stored once in a bank.

    A take appears in every pairing with every other actor, so materialising
    four (1024, 128) copies per quad would grow the dataset ~25x; quads are
    (N, 4) indices into ``fbank_bank`` instead. Quads whose four takes carry
    different emotion labels are left out. Returns {"fbank_bank",
    "quad_idx" int32, "emo_id", "a1_id", "a2_id"} with 0-based labels.
    """
    val_ids = {a.index for a in ACTORS.values() if a.name in STAGE1_VAL_ACTORS}
    drop_ids = {a.index for a in ACTORS.values() if a.name in STAGE1_DROPPED_ACTORS}
    if split == "train":
        ids = [i for i in sorted(ACTORS) if i not in val_ids and i not in drop_ids]
    elif split == "val":
        ids = sorted(val_ids)
    else:
        raise ValueError(split)

    bank_chunks: list[np.ndarray] = []
    bank_pos: dict[tuple[int, str, int], int] = {}  # (actor, take, chunk) -> row

    def bank_index(actor: int, take: str, chunk: int) -> int:
        key = (actor, take, chunk)
        if key not in bank_pos:
            bank_pos[key] = len(bank_chunks)
            bank_chunks.append(np.asarray(per_take[(actor, take)]["fbanks"][chunk], np.float32))
        return bank_pos[key]

    quad_idx, emo_id, a1_id, a2_id = [], [], [], []
    for a1, a2 in itertools.combinations(ids, 2):
        for emotion in EMOTIONS:
            ta, tb = PRETRAINED_TAKES[emotion]
            entries = [per_take.get((a1, ta)), per_take.get((a1, tb)),
                       per_take.get((a2, ta)), per_take.get((a2, tb))]
            if any(e is None for e in entries) or len({e["emo"] for e in entries}) != 1:
                continue
            for c in range(min(e["fbanks"].shape[0] for e in entries)):
                quad_idx.append([bank_index(a1, ta, c), bank_index(a1, tb, c),
                                 bank_index(a2, ta, c), bank_index(a2, tb, c)])
                emo_id.append(entries[0]["emo"])
                a1_id.append(a1 - 1)
                a2_id.append(a2 - 1)
    if not quad_idx:
        return {"fbank_bank": np.zeros((0, 1024, 128), np.float32),
                "quad_idx": np.zeros((0, 4), np.int32), "emo_id": np.zeros(0, np.int32),
                "a1_id": np.zeros(0, np.int32), "a2_id": np.zeros(0, np.int32)}
    return {"fbank_bank": np.stack(bank_chunks), "quad_idx": np.asarray(quad_idx, np.int32),
            "emo_id": np.asarray(emo_id, np.int32), "a1_id": np.asarray(a1_id, np.int32),
            "a2_id": np.asarray(a2_id, np.int32)}


def takes_provenance(takes: Sequence[beat_mod.Take]) -> list[str]:
    """Sorted identity (actor/take) of the wav set a dataset is built from.
    Adding or removing takes forces a rebuild; editing a wav or CSV in place
    does not (delete the npz to force one), as upstream."""
    return sorted(f"{t.actor_id}/{t.take}" for t in takes if t.wav is not None)


def _npz_path(path) -> Path:
    """The file ``np.savez_compressed`` writes: numpy appends ``.npz`` to a
    name without it, so readers normalise the same way."""
    p = Path(path)
    return p if p.name.endswith(".npz") else p.with_name(p.name + ".npz")


def save_dataset(path, train: dict, val: dict, provenance: Optional[list] = None) -> None:
    """Write the splits; ``provenance`` None stores null ("unknown origin")."""
    meta = json.dumps({"takes": None if provenance is None else list(provenance)})
    np.savez_compressed(
        _npz_path(path),
        __meta__=np.frombuffer(meta.encode(), np.uint8),
        **{f"train_{k}": v for k, v in train.items()},
        **{f"val_{k}": v for k, v in val.items()},
    )


def dataset_is_current(path, provenance: list) -> bool:
    """True when ``path`` exists and was built from exactly ``provenance``."""
    p = _npz_path(path)
    if not p.exists():
        return False
    try:
        with np.load(p) as d:
            if "__meta__" not in d.files:
                return False
            meta = json.loads(bytes(d["__meta__"]).decode())
    except (OSError, ValueError, KeyError):
        return False  # unreadable or corrupt: rebuild
    return meta.get("takes") is not None and meta["takes"] == list(provenance)


def load_dataset(path, mesh=None, unpack_dir=None) -> tuple[dict, dict]:
    """The splits of a stage-1 npz -> (train, val) dicts of arrays.

    One process (``mesh=None``) reads each array whole from the npz. In a
    data-parallel run a host holds one copy of the arrays however many ranks
    it runs: the host's local rank 0 unpacks each array once into
    ``<unpack_dir>/<key>.npy`` (``_unpack``; ``unpack_dir`` is a directory of
    the run), a barrier follows, and every rank, local rank 0 included, maps
    the files with ``np.load(mmap_mode="r")``. The mapped pages are the page
    cache's, shared by the host's ranks, and ``batches`` copies only a batch's
    rows out of them. The caller removes ``unpack_dir`` when the run is done
    with it.
    """
    from amuse_tpu_torch.parallel.mesh import barrier, is_local_main

    p = _npz_path(path)
    if mesh is None:
        d = np.load(p)
        arrays = {k: d[k] for k in d.files}
    else:
        if unpack_dir is None:
            raise ValueError("a data-parallel load_dataset needs unpack_dir, a directory "
                             "of the run to unpack the npz into")
        root = Path(unpack_dir)
        if is_local_main(mesh):
            _unpack(p, root)
        barrier(mesh)
        with zipfile.ZipFile(p) as z:
            keys = [n[:-len(".npy")] for n in z.namelist()]
        arrays = {k: np.load(root / f"{k}.npy", mmap_mode="r") for k in keys}
    train = {k[len("train_"):]: v for k, v in arrays.items() if k.startswith("train_")}
    val = {k[len("val_"):]: v for k, v in arrays.items() if k.startswith("val_")}
    return train, val


def _unpack(npz: Path, root: Path) -> None:
    """Each member of ``npz`` (a ``.npy`` file, compressed) copied into
    ``root`` in 1 MB pieces, never decoded whole. A file is written under a
    temporary name that no other writer holds (``_write_new``) and renamed,
    its record (the npz's mtime, its size) written after it; a file whose
    record does not match is written anew, so a crashed or older unpacking is
    never mapped, and the local rank 0 of several hosts may unpack into one
    shared ``root`` at once."""
    root.mkdir(parents=True, exist_ok=True)
    mtime = npz.stat().st_mtime_ns
    with zipfile.ZipFile(npz) as z:
        for info in z.infolist():
            dst, rec = root / info.filename, root / f"{info.filename}.json"
            want = {"source_mtime_ns": mtime, "size": info.file_size}
            if (dst.exists() and rec.exists() and dst.stat().st_size == info.file_size
                    and json.loads(rec.read_text()) == want):
                continue
            rec.unlink(missing_ok=True)
            with z.open(info) as src:
                _write_new(dst, lambda out: shutil.copyfileobj(src, out, 1 << 20))
            _write_new(rec, lambda out: out.write(json.dumps(want).encode()))


def _write_new(dst: Path, write: Callable) -> None:
    """``write(file)`` into a new file beside ``dst``, created exclusively,
    then renamed over ``dst``."""
    fd, tmp = tempfile.mkstemp(prefix=f".{dst.name}.", suffix=".tmp", dir=dst.parent)
    try:
        with os.fdopen(fd, "wb") as out:
            write(out)
        os.replace(tmp, dst)
    except BaseException:
        os.unlink(tmp)
        raise


def batches(data: dict[str, np.ndarray], batch_size: int,
            rng: Optional[np.random.Generator] = None) -> Iterator[dict[str, np.ndarray]]:
    """Yields {"fbanks": (B, 4, T, F), "emo_id", "a1_id", "a2_id"}; the last
    partial batch is dropped. Accepts the index layout (``fbank_bank`` +
    ``quad_idx``) and the older materialised one (a full ``fbanks`` array)."""
    n = data["emo_id"].shape[0]
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    labels = ("emo_id", "a1_id", "a2_id")
    for i in range(0, n - batch_size + 1, batch_size):
        idx = order[i : i + batch_size]
        out = {k: data[k][idx] for k in labels if k in data}
        if "fbank_bank" in data:
            out["fbanks"] = data["fbank_bank"][data["quad_idx"][idx]]
        else:
            out["fbanks"] = data["fbanks"][idx]
        yield out
