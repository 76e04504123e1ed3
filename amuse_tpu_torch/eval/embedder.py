"""External motion feature extractor for FGD (not the evaluated model).

Port of ``amuse_tpu/eval/embedder.py``: a temporal-conv autoencoder over
6D motion windows, trained by plain reconstruction on ground-truth windows
only (``--fn train_embedder``). Its encoder's latent is the feature space
of ``fgd_embedder`` in the eval report.

The module keeps flax's layout and names, so the single-file npz of the
JAX package loads as it is and either package reads the other's file:
flat ``"enc128/kernel"`` keys (convolution kernels (k, in, out), dense
kernels (in, out)) and a ``__meta__`` JSON of the config and the
provenance string. Two of flax's conventions are reproduced exactly: a
stride-2 'SAME' convolution pads unevenly (1 low, 2 high at k 5 over an
even length), and ``ConvTranspose`` (``transpose_kernel=False``) is a
correlation over the stride-dilated input with the kernel not flipped,
'SAME' giving length T * stride. GELU is flax's default tanh form.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_WEIGHTS = Path(__file__).resolve().parent / "weights" / "motion_embedder_synthetic.npz"
KERNEL, STRIDE = 5, 2


@dataclass(frozen=True)
class EmbedderConfig:
    in_dim: int = 333  # 6D motion features (55 * 6 + 3)
    window: int = 300
    channels: tuple = (128, 64)
    latent_dim: int = 64


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _same_pads(length: int) -> tuple[int, int]:
    """flax/lax 'SAME' padding of a stride-STRIDE convolution: (low, high)."""
    out = -(-length // STRIDE)
    total = max((out - 1) * STRIDE + KERNEL - length, 0)
    return total // 2, total - total // 2


# lax.conv_transpose's 'SAME' padding of the dilated input at k 5, stride 2:
# pad_len = k + s - 2 = 5, low = ceil(5 / 2) = 3, high = 2
_TRANSPOSE_PADS = (3, 2)


class Conv(torch.nn.Module):
    """flax ``Conv`` / ``ConvTranspose`` (k 5, stride 2, 'SAME') on (B, T, C)."""

    def __init__(self, c_in: int, c_out: int, transpose: bool = False):
        super().__init__()
        self.transpose = transpose
        self.kernel = torch.nn.Parameter(torch.zeros(KERNEL, c_in, c_out))
        self.bias = torch.nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)  # (B, C, T)
        weight = self.kernel.permute(2, 1, 0)  # (out, in, k), correlated unflipped
        if self.transpose:
            b, c, t = h.shape
            dilated = h.new_zeros((b, c, (t - 1) * STRIDE + 1))
            dilated[..., ::STRIDE] = h
            out = F.conv1d(F.pad(dilated, _TRANSPOSE_PADS), weight, self.bias)
        else:
            out = F.conv1d(F.pad(h, _same_pads(h.shape[-1])), weight, self.bias, stride=STRIDE)
        return out.transpose(1, 2)


class Dense(torch.nn.Module):
    """flax ``Dense``: kernel (in, out)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.zeros(c_in, c_out))
        self.bias = torch.nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class MotionEmbedder(torch.nn.Module):
    """Strided temporal-conv encoder -> latent; mirror decoder for training.
    Submodule names are flax's (``enc128``, ``to_latent``, ...)."""

    def __init__(self, cfg: EmbedderConfig):
        super().__init__()
        if len(set(cfg.channels)) != len(cfg.channels):
            # layer names derive from channel widths, as in the weight files
            raise ValueError(f"EmbedderConfig.channels must be distinct widths, got "
                             f"{cfg.channels}")
        self.cfg = cfg
        c_in = cfg.in_dim
        for ch in cfg.channels:
            self.add_module(f"enc{ch}", Conv(c_in, ch))
            c_in = ch
        self.to_latent = Dense(c_in, cfg.latent_dim)
        t_down = cfg.window
        for _ in cfg.channels:
            t_down = -(-t_down // STRIDE)
        self.t_down = t_down
        self.from_latent = Dense(cfg.latent_dim, t_down * cfg.channels[-1])
        c_in = cfg.channels[-1]
        for ch in reversed(cfg.channels[:-1]):
            self.add_module(f"dec{ch}", Conv(c_in, ch, transpose=True))
            c_in = ch
        self.to_feats = Conv(c_in, cfg.in_dim, transpose=True)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, in_dim) -> (B, latent_dim): the FGD feature map."""
        h = x
        for ch in self.cfg.channels:
            h = _gelu(getattr(self, f"enc{ch}")(h))
        return self.to_latent(h.mean(dim=1))  # global average over time

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T, in_dim) -> (latent (B, latent_dim), reconstruction (B, T, in_dim))."""
        c = self.cfg
        z = self.encode(x)
        h = _gelu(self.from_latent(z)).reshape(z.shape[0], -1, c.channels[-1])
        for ch in reversed(c.channels[:-1]):
            h = _gelu(getattr(self, f"dec{ch}")(h))
        # the strided convolutions round T up by powers of 2; crop back
        return z, self.to_feats(h)[:, :x.shape[1]]


def _flax_key(name: str) -> str:
    return name.replace(".", "/")


def init_params(seed: int, cfg: EmbedderConfig) -> dict[str, torch.Tensor]:
    """Flat ``"enc128/kernel"`` parameters with flax's initialisers, drawn
    from ``seed`` on the CPU: lecun-normal kernels (a normal truncated at
    two standard deviations, variance 1 / fan_in, fan_in the product of all
    but the last dim) and zero biases."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, p in MotionEmbedder(cfg).named_parameters():
        if name.endswith("bias"):
            params[_flax_key(name)] = torch.zeros(p.shape)
            continue
        fan_in = math.prod(p.shape[:-1])
        # a standard normal truncated to [-2, 2] by the inverse CDF, scaled
        # so that the truncated draw has variance 1 / fan_in (flax's constant)
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
        u = lo + (hi - lo) * torch.rand(p.shape, generator=g, dtype=torch.float64)
        w = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std
        params[_flax_key(name)] = w.to(torch.float32)
    return params


def _tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.from_numpy(np.array(v))


def make_model(params: dict, cfg: EmbedderConfig,
               device: str | torch.device = "cuda") -> MotionEmbedder:
    """A float32 ``MotionEmbedder`` on ``device`` holding flat ``params``."""
    model = MotionEmbedder(cfg)
    model.load_state_dict({k.replace("/", "."): _tensor(v) for k, v in params.items()})
    return model.to(device)


def params_of(model: MotionEmbedder) -> dict[str, torch.Tensor]:
    """The model's parameters as flat flax-layout ``"enc128/kernel"`` keys, on the CPU."""
    return {_flax_key(k): v.detach().cpu() for k, v in model.state_dict().items()}


def make_train_step(model: MotionEmbedder, learning_rate: float = 1e-3
                    ) -> tuple[Callable[[torch.Tensor], torch.Tensor], torch.optim.Adam]:
    """(step, optimizer): step(batch (B, T, in_dim)) takes one Adam step of
    the reconstruction MSE and returns the loss (a 0-dim tensor, not
    synchronised). Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8)."""
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def step(batch: torch.Tensor) -> torch.Tensor:
        _, recon = model(batch)
        loss = torch.mean((recon - batch) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, opt


@torch.no_grad()
def embed(model: MotionEmbedder, motion: torch.Tensor) -> torch.Tensor:
    """(B, T, in_dim) -> (B, latent_dim): the FGD feature map."""
    return model.encode(motion)


# ---- single-file npz (de)serialisation, the JAX package's format ----------

def save(path, params: dict, cfg: EmbedderConfig, provenance: str) -> None:
    """Flat ``params`` (tensors or arrays) + config + provenance -> one npz."""
    arrays = {k: _tensor(v).detach().cpu().numpy() for k, v in params.items()}
    meta = json.dumps({"config": asdict(cfg), "provenance": provenance})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)


def load(path) -> tuple[dict[str, torch.Tensor], EmbedderConfig, str]:
    """-> (flat params as CPU tensors, config, provenance)."""
    with np.load(path) as d:
        meta = json.loads(bytes(d["__meta__"]).decode())
        cfg_d = dict(meta["config"], channels=tuple(meta["config"]["channels"]))
        params = {k: torch.from_numpy(d[k]) for k in d.files if k != "__meta__"}
    return params, EmbedderConfig(**cfg_d), meta["provenance"]
