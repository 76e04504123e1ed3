"""Pipeline parameter loading: the port's run directories or released AMUSE files.

Port of ``amuse_tpu/utils/checkpoint_io.py``. ``load_pipeline_params``
reads ``AMUSE_TPU_CKPT`` and resolves, in order:

  1. a run directory (``metadata.json`` / ``step_*``) written by the port's
     ``train.checkpoint.CheckpointManager``, holding ``{"prior",
     "denoiser"}`` state dicts, with the AST from ``AMUSE_TPU_AST_CKPT``. A
     JAX run's orbax directory, converted by the root script
     ``orbax_to_torch.py`` where the JAX package is installed, is such a
     directory and loads the same way; an unconverted one raises, naming
     the script;
  2. a directory of released AMUSE PyTorch files (``*.pt``, ``model_*.pkl``),
     the "best" of each kind selected by the reference's own filename-metric
     grammars (below), so that it loads the files the reference would;
  3. ``None`` when the variable is unset (callers use random weights).

A configured checkpoint that cannot be assembled raises: it never falls
back to random weights. The port's modules carry the reference key names,
so a released state dict needs only its prefixes handled.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Mapping, Optional

import torch

from amuse_tpu_torch.infer.pipeline import PipelineParams


def load_pipeline_params() -> Optional[PipelineParams]:
    """-> PipelineParams of reference-keyed state dicts, or None when
    ``AMUSE_TPU_CKPT`` is unset; a configured but broken checkpoint raises."""
    root = os.environ.get("AMUSE_TPU_CKPT", "")
    if not root:
        return None
    root = Path(root)
    if (root / "metadata.json").exists() or any(root.glob("step_*")):
        params = _from_run_dir(root)
    elif root.is_dir() and any(root.glob("*.pt")):
        params = _from_torch_dir(root)
    else:
        raise FileNotFoundError(
            f"AMUSE_TPU_CKPT={root} is neither a run directory (metadata.json / "
            "step_*) nor a directory of released .pt files"
        )
    if params is None:
        raise ValueError(
            f"AMUSE_TPU_CKPT={root} was found but could not be assembled into "
            "pipeline params - a prior+denoiser checkpoint also needs "
            "AMUSE_TPU_AST_CKPT pointing at the stage-1 run"
        )
    return params


def _unwrap_params(tree):
    """A train state keeps its parameters under ``"params"`` (the port's
    ``train_audio`` state under ``"model"``, beside its optimizer); bare
    parameter trees pass through."""
    for key in ("params", "model"):
        if isinstance(tree, dict) and key in tree:
            return tree[key]
    return tree


def _restore(root: Path):
    """The latest step of a port run directory (or of one converted by
    ``orbax_to_torch.py``); an orbax step directory of the JAX package
    raises ``NotImplementedError`` naming that script's command line."""
    from amuse_tpu_torch.train.checkpoint import CheckpointManager

    tree, _ = CheckpointManager(root).restore()
    return _unwrap_params(tree)


def _from_run_dir(root: Path) -> Optional[PipelineParams]:
    tree = _restore(root)
    if not (isinstance(tree, dict) and {"prior", "denoiser"} <= set(tree)):
        return None
    ast_root = os.environ.get("AMUSE_TPU_AST_CKPT", "")
    if not ast_root:
        return None
    return PipelineParams(ast=_restore(Path(ast_root)), prior=tree["prior"],
                          denoiser=tree["denoiser"])


# --------------------------------------------------- filename-grammar "best"
#
# The reference selects released checkpoints by metrics in the FILENAME:
#   stage-1 AST:
#     model_{e}_tL{:.8f}_tEA{:.8f}_tPA{:.8f}_vL{:.8f}_vEA{:.8f}_vPA{:.8f}.pkl
#     max tEA (field [3]; max tPA, field [4], under the "identity"
#     ablation), numbers read by stripping characters (_get_num); if the
#     winner's epoch is 0, the file containing "_1_" is taken instead.
#   stage-2 prior / latdiff:
#     {prior_model_NoOpt|latdiff_model_wOpt}_recF{:.4f}_..._total{:.4f}_e{e}.pt
#     latdiff with the least total (the first \d+\.\d+ of the second-to-last
#     "_" field; the epoch is the first integer of the last), and the prior
#     saved at that latdiff's epoch.


def _get_num(field: str) -> Optional[float]:
    """Non-digit, non-dot characters become spaces; the first token parses
    as a float ("tEA0.9512" -> 0.9512)."""
    toks = "".join(c if c.isdigit() or c == "." else " " for c in field).split()
    return float(toks[0]) if toks else None


def select_ast_checkpoint(paths: list, ablation: Optional[str] = None):
    """The stage-1 file with the greatest tEA (tPA under ``ablation ==
    "identity"``), with the epoch-0 -> "_1_" quirk; files whose stems do not
    parse are skipped, and if none parse the lexicographically last wins."""
    best, best_score = None, -float("inf")
    field = 4 if ablation == "identity" else 3
    for p in paths:
        parts = Path(p).stem.split("_")
        score = _get_num(parts[field]) if len(parts) > field else None
        if score is not None and score > best_score:
            best, best_score = p, score
    if best is None:
        return sorted(paths)[-1]
    epoch = _get_num(Path(best).stem.split("_")[1])
    if epoch is not None and int(epoch) == 0:
        with_1 = [p for p in paths if "_1_" in str(p)]
        if with_1:
            return with_1[0]
    return best


def _total_and_epoch(path) -> tuple[Optional[float], Optional[int]]:
    parts = Path(path).stem.split("_")
    if len(parts) < 2:
        return None, None
    m_total = re.findall(r"\d+\.\d+", parts[-2])
    m_epoch = re.search(r"\d+", parts[-1])
    return (float(m_total[0]) if m_total else None,
            int(m_epoch.group()) if m_epoch else None)


def select_latdiff_checkpoint(paths: list):
    """The file with the least total loss -> (path, epoch); the
    lexicographically last when no name parses."""
    best, best_total, best_epoch = None, float("inf"), None
    for p in paths:
        total, epoch = _total_and_epoch(p)
        if total is not None and total < best_total:
            best, best_total, best_epoch = p, total, epoch
    if best is None:
        p = sorted(paths)[-1]
        return p, _total_and_epoch(p)[1]
    return best, best_epoch


def select_prior_checkpoint(paths: list, epoch: Optional[int]):
    """The prior saved at the chosen latdiff's epoch; the least total when no
    epoch matches (a release that ships a single prior file)."""
    if epoch is not None:
        matches = [p for p in paths if _total_and_epoch(p)[1] == epoch]
        if matches:
            return matches[0]
    return select_latdiff_checkpoint(paths)[0]


# --------------------------------------------------------- state-dict prefixes


def state_dict_is_dataparallel(sd: Mapping) -> bool:
    return bool(sd) and all(k.startswith("module.") for k in sd)


def strip_dataparallel_prefix(sd: Mapping) -> dict:
    """Strip a leading ``module.`` iff EVERY key carries it.

    ``nn.DataParallel`` prefixes every key of the wrapped model's state dict,
    and the reference saves its stage-1 model wrapped; a bare state dict, or
    one with a genuine submodule named ``module`` among other keys, passes
    through untouched.
    """
    if state_dict_is_dataparallel(sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def strip_module_prefix(sd: Mapping, prefix: str) -> dict:
    """The keys under ``prefix.``, with it stripped (e.g. 'denoiser.')."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _load_state_dict(path: Path) -> dict:
    """A released file -> its state dict on the CPU, DataParallel layout
    stripped. ``weights_only``: tensors and containers only, never code."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    sd = ck.get("model_state_dict", ck) if isinstance(ck, dict) else ck
    return strip_dataparallel_prefix(sd)


def released_files(root: Path) -> Optional[dict[str, Path]]:
    """The three files a released directory resolves to, {"ast", "prior",
    "denoiser"}, or None when a kind is missing."""
    root = Path(root)
    ast = (sorted(root.glob("*ast*.pt")) or sorted(root.glob("*dtw*.pt"))
           or sorted(root.glob("model_*.pkl")))
    prior = sorted(root.glob("prior*.pt"))
    latdiff = sorted(root.glob("latdiff*.pt"))
    if not (ast and prior and latdiff):
        return None
    latdiff_best, ldm_epoch = select_latdiff_checkpoint(latdiff)
    return {"ast": select_ast_checkpoint(ast),
            "prior": select_prior_checkpoint(prior, ldm_epoch),
            "denoiser": latdiff_best}


def _from_torch_dir(root: Path) -> Optional[PipelineParams]:
    files = released_files(root)
    if files is None:
        return None
    return PipelineParams(
        ast=_load_state_dict(files["ast"]),
        prior=_load_state_dict(files["prior"]),
        denoiser=strip_module_prefix(_load_state_dict(files["denoiser"]), "denoiser"),
    )
