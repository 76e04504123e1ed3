"""Hyper-parameter optimisation: random search + ASHA successive halving.

The port's copy of ``amuse_tpu/cluster/sweep.py``: a typed search space with
log-uniform / uniform / choice dimensions mirroring the reference's SMAC3
sweep knobs (scripts/sweep_full_train.py:41-58), and ASHA (asynchronous
successive halving), which promotes trials through rungs of increasing
budget (epochs) and culls stragglers. Results persist to a JSONL ledger so
a sweep resumes across preemptions. Unlike the JAX package's copy, a torn
last line (a crash in the middle of a write) is in-flight work: it is cut
from the ledger and its unit is redone, where the JAX copy raises.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float
    log: bool = False

    def sample(self, rng: np.random.Generator) -> float:
        if self.log:
            return float(np.exp(rng.uniform(math.log(self.lo), math.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))


@dataclass(frozen=True)
class IntChoice:
    options: tuple

    def sample(self, rng: np.random.Generator):
        return self.options[int(rng.integers(len(self.options)))]


# The reference's prior-sweep space (sweep_full_train.py:41-58), translated.
PRIOR_SPACE = {
    "batch_size": IntChoice((16, 32, 64)),
    "learning_rate": Uniform(1e-5, 1e-3, log=True),
    "latent_dim": IntChoice((64, 128, 256)),
    "ff_size": IntChoice((256, 512, 1024)),
    "num_layers": IntChoice((5, 7, 9, 11)),
    "num_heads": IntChoice((2, 4, 8)),
    "dropout": Uniform(0.0, 0.3),
    "lambda_kl": Uniform(1e-6, 1e-3, log=True),
}


def sample_config(space: dict, rng: np.random.Generator) -> dict:
    return {k: v.sample(rng) for k, v in space.items()}


@dataclass
class Trial:
    trial_id: int
    config: dict
    rung: int = 0
    budget: int = 0
    score: float = math.inf
    state: str = "pending"  # pending | running | completed | culled


class ASHA:
    """Asynchronous successive halving over epoch budgets.

    objective(config, budget_epochs, trial_id) -> score (lower is better).
    """

    def __init__(
        self,
        space: dict,
        objective: Callable[[dict, int, int], float],
        min_budget: int = 1,
        max_budget: int = 27,
        reduction: int = 3,
        seed: int = 0,
        out_file: Optional[Path] = None,
    ):
        self.space = space
        self.objective = objective
        self.reduction = reduction
        self.rungs = []
        b = min_budget
        while b <= max_budget:
            self.rungs.append(b)
            b *= reduction
        self.rng = np.random.default_rng(seed)
        self.trials: list[Trial] = []
        self.out_file = Path(out_file) if out_file else None
        self._replay_ledger()

    def _replay_ledger(self) -> None:
        """Resume from the JSONL ledger: completed units replay into
        ``self.trials`` (in-flight work at crash time is simply redone), and
        the config-sampling RNG stream is advanced past the configs already
        drawn so a resumed sweep continues exactly where a continuous one
        would (same seed -> same future trials)."""
        if not self.out_file or not self.out_file.exists():
            return
        seen_ids: set[int] = set()
        lines = self.out_file.read_text().splitlines(keepends=True)
        last = max((i for i, ln in enumerate(lines) if ln.strip()), default=-1)
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                trial = _ledger_trial(line)
            except (ValueError, KeyError, TypeError) as e:
                if i != last:  # damage before the end is not a torn write
                    raise ValueError(f"{self.out_file}:{i + 1}: malformed ledger line") from e
                # a write torn by the crash: cut it, so that the next record
                # starts on a line of its own, and redo its unit
                self.out_file.write_text("".join(lines[:i]))
                break
            self.trials.append(trial)
            seen_ids.add(trial.trial_id)
        else:
            if lines and not lines[-1].endswith("\n"):  # whole record, newline lost
                with open(self.out_file, "a") as f:
                    f.write("\n")
        # each NEW trial consumed exactly one sample_config draw; promotions
        # consumed none - burn the same number of draws
        for _ in seen_ids:
            sample_config(self.space, self.rng)

    def _record(self, trial: Trial) -> None:
        if self.out_file:
            with open(self.out_file, "a") as f:
                f.write(
                    json.dumps(
                        {
                            "trial": trial.trial_id,
                            "rung": trial.rung,
                            "budget": trial.budget,
                            "score": trial.score,
                            "config": trial.config,
                            "time": time.time(),
                        }
                    )
                    + "\n"
                )

    def _promotable(self, rung: int) -> Optional[Trial]:
        """Top-1/reduction trials of a rung that haven't advanced yet."""
        done = [t for t in self.trials if t.rung == rung and t.state == "completed"]
        if len(done) < self.reduction:
            return None
        done.sort(key=lambda t: t.score)
        top_k = max(1, len(done) // self.reduction)
        advanced = {t.trial_id for t in self.trials if t.rung > rung}
        for t in done[:top_k]:
            if t.trial_id not in advanced:
                return t
        return None

    def step(self) -> Trial:
        """Pick the next unit of work (promotion first, else a new trial)."""
        for rung in range(len(self.rungs) - 2, -1, -1):
            cand = self._promotable(rung)
            if cand is not None:
                promoted = Trial(cand.trial_id, cand.config, cand.rung + 1)
                self.trials.append(promoted)
                return promoted
        t = Trial(len({x.trial_id for x in self.trials}), sample_config(self.space, self.rng))
        self.trials.append(t)
        return t

    def run_trial(self, trial: Trial) -> float:
        trial.state = "running"
        trial.budget = self.rungs[trial.rung]
        trial.score = float(self.objective(trial.config, trial.budget, trial.trial_id))
        trial.state = "completed"
        self._record(trial)
        return trial.score

    def run(self, num_units: int) -> Trial:
        """Execute num_units sequential units of work; return the best trial
        (highest budget reached, then lowest score)."""
        for _ in range(num_units):
            self.run_trial(self.step())
        return best_trial(self.trials)


def _ledger_trial(line: str) -> Trial:
    """One completed unit from a ledger line; raises on a malformed line."""
    rec = json.loads(line)
    return Trial(trial_id=int(rec["trial"]), config=dict(rec["config"]), rung=int(rec["rung"]),
                 budget=int(rec["budget"]), score=float(rec["score"]), state="completed")


def best_trial(trials: list[Trial]) -> Trial:
    done = [t for t in trials if t.state == "completed"]
    return min(done, key=lambda t: (-t.budget, t.score))
