"""Stage-1 dataset file: (actor1, actor2) x (take1, take2) fbank quads.

The numpy-only part of ``amuse_tpu/data/stage1.py``: the npz layout that the
JAX ``prepare_data`` writes (``train_*`` / ``val_*`` arrays plus a
``__meta__`` provenance record), read and written byte for byte the same,
and the batch iterator. A dataset holds each take's fbank chunks once in
``fbank_bank`` (M, 1024, 128) with ``quad_idx`` (N, 4) indices into it, and
0-based ``emo_id``, ``a1_id``, ``a2_id`` labels; ``batches`` gathers the
quads at batch time. Building the quads from BEAT takes (``fbanks_per_take``,
``build_quads``) is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


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


def load_dataset(path) -> tuple[dict, dict]:
    d = np.load(_npz_path(path))
    train = {k[len("train_"):]: d[k] for k in d.files if k.startswith("train_")}
    val = {k[len("val_"):]: d[k] for k in d.files if k.startswith("val_")}
    return train, val


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
