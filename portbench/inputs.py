"""What the benchmark makes from ``--seed``: weights, audio and the
sub-seeds of requests. Weights and audio are drawn on the device with one
``torch.Generator`` in a few large calls."""

from __future__ import annotations

import math

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SEED_MASK = (1 << 63) - 1


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of ``seed``, given by ``path`` (integers of
    either sign)."""
    words = np.random.SeedSequence([2 * abs(x) + (x < 0) for x in (seed, *path)]
                                   ).generate_state(2)
    return ((int(words[0]) << 32) | int(words[1])) & SEED_MASK


def _bounds(key: str, shapes: dict) -> tuple[float, float]:
    """U(low, high) for one tensor: the bounds of PyTorch's own initialisers
    for the module that holds it (the program's ``init_random_params`` draws
    from these on the host), and small ranges about the constants that
    PyTorch starts some tensors at, so that the check sees them too."""
    shape = shapes[key]
    if key.endswith("in_proj_weight"):  # nn.MultiheadAttention: xavier_uniform
        b = math.sqrt(6.0 / (shape[0] + shape[1]))
        return -b, b
    if key.endswith(".pe"):  # learned positions: uniform on [0, 1)
        return 0.0, 1.0
    if key.endswith("global_motion_token"):  # randn: the same variance
        return -math.sqrt(3.0), math.sqrt(3.0)
    if key.endswith("pos_embed"):  # trunc_normal(std=0.02): the same variance
        return -0.02 * math.sqrt(3.0), 0.02 * math.sqrt(3.0)
    weight = shapes.get(key[: -len("bias")] + "weight") if key.endswith("bias") else None
    if key.endswith("weight") and len(shape) > 1:  # Linear and Conv2d: kaiming_uniform(a=sqrt 5)
        b = 1.0 / math.sqrt(math.prod(shape[1:]))
        return -b, b
    if weight is not None and len(weight) > 1:  # their biases
        b = 1.0 / math.sqrt(math.prod(weight[1:]))
        return -b, b
    if key.endswith("weight"):  # LayerNorm gain, 1
        return 0.9, 1.1
    return -0.02, 0.02  # LayerNorm and attention biases, class tokens: 0


def draw_weights(shapes: dict[str, tuple], dtype: torch.dtype, generator: torch.Generator,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """{key: shape} -> {key: tensor} of ``dtype`` on ``device``: views of one
    buffer drawn uniform in one call, each view mapped to its bounds in place."""
    keys = list(shapes)
    sizes = [math.prod(shapes[k]) for k in keys]
    flat = torch.rand(sum(sizes), generator=generator, device=device, dtype=dtype)
    for key, part in zip(keys, flat.split(sizes)):
        low, high = _bounds(key, shapes)
        part.mul_(high - low).add_(low)
    return {k: t.view(shapes[k]) for k, t in zip(keys, flat.split(sizes))}


def make_weights(shapes: dict, types: dict, seed: int, device: torch.device) -> dict:
    """{part: {key: shape}} -> {part: state dict}, each part drawn in its
    served type (``types[part]``) from one generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    return {part: draw_weights(shapes[part], DTYPES[types[part]], g, device)
            for part in sorted(shapes)}


def speech_like(windows: int, samples: int, rate: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """(windows, samples) float32 voiced speech stand-in: 12 harmonics of a
    pitch that wanders about 90-250 Hz, shaped by a syllable-rate (3-6 Hz)
    envelope with pauses, plus breath noise, at an RMS near 0.05."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    t = torch.arange(samples, device=device, dtype=torch.float64) / rate
    f0 = 90.0 + 160.0 * u(windows, 1).double()
    vibrato = 1.0 + 0.12 * torch.sin(2 * math.pi * (0.3 + 0.7 * u(windows, 1).double()) * t
                                      + 2 * math.pi * u(windows, 1).double())
    phase = 2 * math.pi * torch.cumsum(f0 * vibrato, dim=1) / rate
    voice = sum(torch.sin(h * phase) / h for h in range(1, 13))
    syllable = 3.0 + 3.0 * u(windows, 1).double()
    env = torch.relu(torch.sin(2 * math.pi * syllable * t + 2 * math.pi * u(windows, 1).double()))
    noise = torch.randn((windows, samples), generator=g, device=device, dtype=torch.float64)
    wave = env * voice + 0.05 * noise
    wave = wave / wave.pow(2).mean(dim=1, keepdim=True).sqrt() * 0.05
    return wave.float()
