"""Shared helpers of the legacy-zoo comparison tests: seeded random flax
variables, loaded into the port through ``convert.legacy_from_jax``."""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from amuse_tpu_torch import convert


def random_variables(variables, seed: int, scale: float = 0.3):
    """Every leaf of a flax variables tree from a seeded numpy normal, as
    numpy arrays: LayerNorm/BatchNorm scales around 1, BatchNorm running
    variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        a = rng.normal(scale=scale, size=np.shape(x)).astype(np.float32)
        if name == "scale":
            a += 1.0
        if name == "var":
            a = np.abs(a) + 0.5
        return a

    return jax.tree_util.tree_map_with_path(draw, variables)


def shapes_of(init, *args, **kwargs):
    """The variables tree ``init(key, *args)`` would return, as shape structs."""
    return jax.eval_shape(functools.partial(init, **kwargs), jax.random.key(0), *args)


def load(module: torch.nn.Module, tag: str, variables) -> torch.nn.Module:
    """``module`` holding ``variables`` (strict: every key on both sides), in eval mode."""
    module.load_state_dict(convert.legacy_from_jax(tag, variables))
    return module.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def max_err(mine, ref) -> float:
    mine = mine.detach().numpy() if torch.is_tensor(mine) else np.asarray(mine)
    return float(np.max(np.abs(mine.astype(np.float64) - np.asarray(ref, np.float64))))
