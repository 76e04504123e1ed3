"""Stage-1 training: the AST speech disentangler's swap objective.

Port of ``amuse_tpu/train/audio.py`` (reference ``trainer.train_dtw_ast`` +
``AST_EVP.forward``). One step over a batch of B (actor1, actor2) x (take1,
take2) fbank quads:

  * the 4 quad members stack into one (4B, T, F) virtual batch, augmented
    per member (``spec_augment``), and the three encoders run ONCE over it,
    stacked: one K1 launch per ViT block forward and one K2 launch per block
    in the backward (``models/ast.py``);
  * the 16 reconstruction feature combinations are gathered into a
    (16, B, 3 fd) tensor and go through fusion + decoder in one call (the
    group axis keeps the reference's batch-as-sequence semantics);
  * ``losses.ast_swap_losses``, backward, then Adam with L2 weight decay
    (torch ``Adam(weight_decay=)``: the decay is added to the raw gradient,
    the JAX ``FusedAdam`` mode "l2"), fused on CUDA.

The model computes in its ``dtype`` (bf16 on the main path) over float32
master parameters. Randomness (augmentation, dropout) comes from one
``torch.Generator`` per step, seeded from (seed, epoch, step) by
``step_generator``, so a resumed run replays the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from amuse_tpu_torch.models.ast import ASTConfig, ASTDisentangler
from amuse_tpu_torch.train import losses as L


@dataclass(frozen=True)
class AudioTrainConfig:
    learning_rate: float = 1e-5
    beta1: float = 0.95
    beta2: float = 0.999
    weight_decay: float = 5e-7  # torch Adam style: L2 term added to grads
    lr_decay_start_epoch: int = 5
    lr_decay_gamma: float = 0.85
    epochs: int = 25
    frame_based_feats: bool = True
    # SpecAugment (train-time, reference dm/dataload.py:222-248)
    freq_mask: int = 24
    time_mask: int = 96
    noise_aug: bool = True


def lr_schedule(cfg: AudioTrainConfig, epoch: int) -> float:
    """MultiStepLR(milestones=range(start, epochs), gamma) at epoch granularity."""
    decays = max(0, epoch - cfg.lr_decay_start_epoch + 1)
    return cfg.learning_rate * (cfg.lr_decay_gamma**decays)


class AudioTrainState:
    """The model, its Adam optimizer and the count of steps taken."""

    def __init__(self, model: ASTDisentangler, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def make_optimizer(model: torch.nn.Module, cfg: AudioTrainConfig) -> torch.optim.Adam:
    on_cuda = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                            weight_decay=cfg.weight_decay, fused=on_cuda)


def init_state(seed: int, cfg: AudioTrainConfig = AudioTrainConfig(),
               dtype: torch.dtype = torch.bfloat16, ast_cfg: ASTConfig = ASTConfig(),
               device: str | torch.device = "cuda") -> AudioTrainState:
    """Random float32 weights drawn from ``seed`` on the CPU, moved to ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ASTDisentangler(ast_cfg, dtype=dtype)
    model.to(device)
    return AudioTrainState(model, make_optimizer(model, cfg))


# Peak device memory of a train step without remat, in two parts measured
# at the flagship widths (bf16 compute) on an H100 by chip_smoke.py (phase
# train_audio_step, from the peaks at 1 and 3 quads), which also holds
# ``step_peak_bytes`` against both peaks: bytes per parameter (float32
# parameters, gradients and two Adam moments, plus the step's bf16 copies)
# and bytes per stored ViT activation element (token x embed channel x
# block, over a quad's 12 encoder passes: 3 encoders x 4 fbanks; the fusion
# and decoder activations of the quad ride on it).
FIXED_BYTES_PER_PARAM = 19.3
ACT_BYTES_PER_ELEMENT = 45.0


def step_peak_bytes(ast_cfg: ASTConfig, quads: int, dtype: torch.dtype) -> float:
    """Estimated peak device memory of one train step without remat at
    ``quads`` quads per step (float32 compute keeps twice the bf16
    activation bytes)."""
    with torch.device("meta"):
        n_params = sum(p.numel() for p in ASTDisentangler(ast_cfg).parameters())
    elements = 12 * quads * ast_cfg.depth * (ast_cfg.num_patches + 2) * ast_cfg.embed_dim
    act = elements * ACT_BYTES_PER_ELEMENT * (2 if dtype == torch.float32 else 1)
    return FIXED_BYTES_PER_PARAM * n_params + act


def remat_needed(ast_cfg: ASTConfig, quads: int, dtype: torch.dtype,
                 device: torch.device) -> bool:
    """Whether a step without remat would take more than 90% of the card's
    memory (then each ViT block is recomputed in the backward instead of
    kept). Never on the CPU."""
    if device.type != "cuda":
        return False
    total = torch.cuda.get_device_properties(device).total_memory
    return step_peak_bytes(ast_cfg, quads, dtype) > 0.9 * total


def step_generator(seed: int, epoch: int, step: int,
                   device: str | torch.device) -> torch.Generator:
    """The generator of one step's draws, from (seed, epoch, step): epoch and
    step enter separately, so no two steps of a run share their draws."""
    hi, lo = np.random.SeedSequence([seed, epoch, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def spec_augment(generator: Optional[torch.Generator], fbank: torch.Tensor, freq_mask: int,
                 time_mask: int, noise: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Train-time augmentation of (N, T, F) fbanks -> ``(target, model_input)``.

    Per member, as the JAX ``spec_augment`` and torchaudio draw them: a mask
    width uniform on {0..mask-1}, then its start uniform on [0, len - width],
    for frequency and then time; the masked fbank is the reconstruction
    target. With ``noise`` the model input adds uniform noise scaled by a
    per-member amplitude in [0, 1) / 10 and rolls it along time by a shift
    in [-10, 10).
    """
    n, t_len, f_len = fbank.shape
    dev = fbank.device

    def band(length: int, mask: int) -> torch.Tensor:  # (n, length) True where masked
        width = torch.randint(0, max(mask, 1), (n,), generator=generator, device=dev)
        u = torch.rand(n, generator=generator, device=dev)
        start = (u * (length - width + 1)).floor().long()
        idx = torch.arange(length, device=dev)
        return (idx >= start[:, None]) & (idx < (start + width)[:, None])

    masked = band(f_len, freq_mask)[:, None, :] | band(t_len, time_mask)[:, :, None]
    fbank = fbank.masked_fill(masked, 0.0)
    if not noise:
        return fbank, fbank
    amp = torch.rand((n, 1, 1), generator=generator, device=dev)
    noisy = fbank + torch.rand(fbank.shape, generator=generator, device=dev) * amp / 10.0
    shift = torch.randint(-10, 10, (n,), generator=generator, device=dev)
    src = (torch.arange(t_len, device=dev)[None, :] - shift[:, None]) % t_len  # roll by shift
    return fbank, noisy.gather(1, src[:, :, None].expand(-1, -1, f_len))


def swap_groups(f_emo: torch.Tensor, f_sty: torch.Tensor, f_con: torch.Tensor) -> torch.Tensor:
    """(4, B, fd) features per quad member [a1t1, a1t2, a2t1, a2t2] -> the 16
    [emo|sty|con] combinations (16, B, 3 fd): self x4, content swap (same
    take, other actor), emotion swap and style swap (same actor, other take)."""
    ident = torch.arange(4, device=f_emo.device)  # index tensors made on the device
    partner, other_take = (ident + 2) % 4, ident ^ 1

    def combos(e, s, c):
        return torch.cat([f_emo.index_select(0, e), f_sty.index_select(0, s),
                          f_con.index_select(0, c)], dim=-1)

    return torch.cat([combos(ident, ident, ident), combos(ident, ident, partner),
                      combos(other_take, ident, ident), combos(ident, other_take, ident)])


def loss_fn(model: ASTDisentangler, batch: dict, cfg: AudioTrainConfig,
            generator: Optional[torch.Generator] = None,
            augment: bool = True) -> tuple[torch.Tensor, dict]:
    """Stage-1 objective on one batch of device tensors -> (total, logs).

    ``batch``: fbanks (B, 4, T, F) float32 clean normalised quads [a1t1,
    a1t2, a2t1, a2t2]; emo_id, a1_id, a2_id (B,) 0-based labels. Dropout
    follows ``model.training``.
    """
    clean = batch["fbanks"]
    b, _, t_len, f_len = clean.shape
    quad = clean.transpose(0, 1).reshape(4 * b, t_len, f_len)  # member-major virtual batch
    if augment and (cfg.noise_aug or cfg.freq_mask or cfg.time_mask):
        target, flat = spec_augment(generator, quad, cfg.freq_mask, cfg.time_mask,
                                    cfg.noise_aug)
    else:
        target = flat = quad
    enc = model.encode(flat, cfg.frame_based_feats)
    f_emo, f_sty, f_con = (enc[k]["feature"].view(4, b, -1) for k in ("emo", "sty", "con"))
    recons = model.reconstruct(swap_groups(f_emo, f_sty, f_con), generator)  # (16, B, T, F)
    return L.ast_swap_losses(
        recons, target.view(4, b, t_len, f_len), enc["emo"]["logits"].view(4, b, -1),
        enc["sty"]["logits"].view(4, b, -1), f_con,
        batch["emo_id"], batch["a1_id"], batch["a2_id"])


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch from ``data.stage1.batches`` -> device tensors."""
    out = {k: torch.as_tensor(np.asarray(v), dtype=torch.long).to(device)
           for k, v in batch.items() if k != "fbanks"}
    out["fbanks"] = torch.as_tensor(np.asarray(batch["fbanks"]), dtype=torch.float32).to(device)
    return out


def make_train_step(cfg: AudioTrainConfig = AudioTrainConfig()):
    """-> (train_step, set_lr).

    ``train_step(state, batch, generator, stochastic=True)`` runs one step in
    place and returns the logs (detached device tensors). ``stochastic=False``
    turns dropout and augmentation off (the comparison tests' switch).
    ``set_lr(state, epoch)`` applies the MultiStepLR schedule.
    """

    def train_step(state: AudioTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   stochastic: bool = True) -> dict:
        state.model.train(stochastic)
        total, logs = loss_fn(state.model, batch, cfg, generator, augment=stochastic)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in logs.items()}

    def set_lr(state: AudioTrainState, epoch: int) -> AudioTrainState:
        for group in state.optimizer.param_groups:
            group["lr"] = lr_schedule(cfg, epoch)
        return state

    return train_step, set_lr
