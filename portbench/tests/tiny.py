"""A cell of ``BENCHMARK.json`` cut to widths the CPU runs in seconds: the
harness, the traffic and the check as a run drives them."""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

from portbench import manifest

ROOT = Path(__file__).resolve().parents[2]
AST = {"embed_dim": 64, "depth": 2, "num_heads": 2, "feature_dim": 24}
WIDTHS = {"infer": {"ast": {**AST, "dtype": "float32"},
                    "denoiser": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                                 "num_heads": 2, "cond_dim": 24},
                    "prior": {"latent_dim": 32, "ff_size": 64, "num_layers": 3, "num_heads": 2},
                    "diffusion": {"num_inference_steps": 3}},
          # the fusion and decoder keep the program's fixed 4 heads and 2,048
          "stage1": {"ast": {**AST, "input_tdim": 64, "input_fdim": 32},
                     "stage1": {"fusion_dim": 32},
                     "train": {"dtype": "float32", "freq_mask": 8, "time_mask": 16}}}
SIZES = {"infer.b32": [4], "infer.clips": [1, 2, 3], "stage1.q8": [2], "stage1.dp4": [4]}
POOL = {"infer": 8, "stage1": 8, "stage1.dp4": 16}  # by cell, else by system


def cell(name: str) -> manifest.Cell:
    """The cell at tiny widths, with a small pool of samples and small requests."""
    full = manifest.cell(ROOT, name)
    cfg = copy.deepcopy(full.config)
    for part, values in WIDTHS[cfg["system"]].items():
        cfg[part].update(values)
    mix = dict(full.traffic, pool_samples=POOL.get(name, POOL[cfg["system"]]), warmup_rounds=1,
               samples_per_request=SIZES[name])
    return dataclasses.replace(full, config=cfg, traffic=mix)
