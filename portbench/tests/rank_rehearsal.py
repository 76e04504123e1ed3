"""One rank of ``stage1.dp4`` at tiny widths (``tiny.py``) on the CPU over
gloo, run by ``test_portbench_ranks.py`` through ``ranks.launch``:

    python portbench/tests/rank_rehearsal.py --seed <n> --seconds <s> --trace <0|1>
        --launched-at <host clock> [--fault exchange|unchanged|half] [--fail-rank <r>]

``--fault`` breaks the timed path underneath on every rank: the exchange
left out (every rank steps on its own gradient), Adam's step returning the
state unchanged, or half of each rank's quads left out of the loss.
``--fail-rank`` makes that rank raise at its first request of the window.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path
from unittest import mock

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from amuse_tpu_torch.train import audio as train_audio  # noqa: E402
from portbench import run  # noqa: E402
from portbench.systems import stage1_dp  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from portbench.tests.test_portbench_rehearsal import _half_loss  # noqa: E402


def _fail_in_the_window(real):
    def broken(self, r):
        if r.index >= 0:
            raise RuntimeError(f"a planted failure at request {r.index}")
        return real(self, r)
    return broken


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--launched-at", type=float, required=True)
    p.add_argument("--fault", choices=("exchange", "unchanged", "half"), default=None)
    p.add_argument("--fail-rank", type=int, default=None)
    args = p.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.fault == "exchange":
            stack.enter_context(stage1_dp.exchange_left_out())
        elif args.fault == "unchanged":
            stack.enter_context(mock.patch.object(torch.optim.Adam, "step",
                                                  lambda self, closure=None: None))
        elif args.fault == "half":
            stack.enter_context(mock.patch.object(train_audio, "loss_fn",
                                                  _half_loss(train_audio.loss_fn)))
        if args.fail_rank is not None and args.fail_rank == int(os.environ["RANK"]):
            stack.enter_context(mock.patch.object(
                stage1_dp.Session, "request", _fail_in_the_window(stage1_dp.Session.request)))
        return run.run_rank(tiny.cell("stage1.dp4"), args.seed, args.seconds, bool(args.trace),
                            args.launched_at, device_type="cpu")


if __name__ == "__main__":
    sys.exit(main())
