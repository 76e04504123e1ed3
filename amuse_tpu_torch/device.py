"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and raise when CUDA is absent: they never
quietly run on the CPU. On the card, TF32 is switched off for both matmuls
and cuDNN so float32 products run in full float32, as the JAX reference's
tests do (``jax_default_matmul_precision="highest"``).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """-> a checked ``torch.device``; CUDA requested without a GPU raises.

    Selecting CUDA sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` for the process.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
