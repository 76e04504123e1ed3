"""The one traffic generator: request sizes and inputs from a mix's
parameters (``traffic/<mix>.json``) and the run's seed.

A mix names the program's entry it drives and gives:

  entry                  the program's call a request makes; the
                         configuration's system (``systems/<system>.py``)
                         names the entries it drives and refuses others
                         (``wav_to_motion``, ``infer_wav``, ``train_step``)
  loop, clients          "closed" with 1 client: the next request is sent
                         when the last one has returned
  samples_per_request    the sizes of requests in samples (the config's
                         ``sample``: a 10 s window, a quad); every block of
                         len(sizes) requests holds each size once, in an
                         order drawn from the seed, so each seed sends the
                         same set of sizes
  pool_samples           distinct samples made in set-up; a request takes
                         a run of them from a seeded start
  warmup_rounds          warm-up requests of every size before the window
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from portbench.inputs import sub_seed


@dataclass(frozen=True)
class Request:
    index: int
    samples: int  # samples in the request
    start: int  # first window of the pool it takes
    seed: int  # the request's sub-seed (initial latents, generator)


@dataclass
class Done:
    """One request served: its host-clock span and what came back (motion
    for the inference entries; nothing for a train step)."""

    request: Request
    start: float
    end: float
    poses: Optional[np.ndarray] = None
    trans: Optional[np.ndarray] = None


class Traffic:
    def __init__(self, mix: dict, seed: int):
        if mix.get("loop") != "closed" or mix.get("clients") != 1:
            raise ValueError("this generator drives one closed-loop client")
        self.mix, self.seed = mix, seed
        self.sizes = [int(n) for n in mix["samples_per_request"]]
        self.pool = int(mix["pool_samples"])
        if max(self.sizes) > self.pool:
            raise ValueError("a request is larger than the pool of samples")

    def request(self, index: int) -> Request:
        """Request ``index`` (negative indices are warm-up requests)."""
        block, pos = divmod(index, len(self.sizes))
        order = np.random.default_rng(sub_seed(self.seed, 4, block)).permutation(len(self.sizes))
        n = self.sizes[order[pos]]
        rng = np.random.default_rng(sub_seed(self.seed, 5, index))
        return Request(index, n, int(rng.integers(0, self.pool - n + 1)),
                       sub_seed(self.seed, 6, index))

    def warmup(self) -> list[Request]:
        """Each size ``warmup_rounds`` times, at indices below 0."""
        out, index = [], -1
        for _ in range(int(self.mix["warmup_rounds"])):
            for n in sorted(set(self.sizes)):
                r = self.request(index)
                out.append(Request(index, n, min(r.start, self.pool - n), r.seed))
                index -= 1
        return out
