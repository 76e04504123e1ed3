"""What the systems' sessions share: the AST's configuration keys, the
program's launch counters, the device's clock and the release of the
program's state before the reference runs."""

from __future__ import annotations

import gc
import time

import torch

AST_KEYS = ("input_tdim", "input_fdim", "patch", "fstride", "tstride", "embed_dim", "depth",
            "num_heads", "mlp_ratio", "feature_dim")


def check_entry(mix: dict, entries: tuple) -> None:
    """A system drives the entries it names; any other is refused here."""
    if mix["entry"] not in entries:
        raise ValueError(f"this system drives {entries}, not the entry {mix['entry']!r}")


class Session:
    """A system's session: ``device`` and, in ``release``, the names of the
    attributes that hold the program's state (``PROGRAM``)."""

    PROGRAM: tuple = ()
    device: torch.device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counts(self) -> dict:
        """The program's launch counters by kernel family."""
        from amuse_tpu_torch.ops import attention, denoiser_kernel

        return {"attention_fwd": attention.mha.launches,
                "attention_bwd": attention.mha_bwd.launches,
                "ddim_sampler": denoiser_kernel.ddim_sample_fused.launches}

    def finish(self) -> float:
        """The host clock once the device has done all the work enqueued."""
        self._sync()
        return time.perf_counter()

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in self.PROGRAM:
            delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
