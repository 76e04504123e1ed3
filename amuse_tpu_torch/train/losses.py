"""Loss functions of both training stages (port of ``amuse_tpu/train/losses.py``).

Stage 2 (LPDM) mirrors the reference ``LatentPriorLosses``
(``latent_losses.py:101-151``): SmoothL1 feature reconstruction, KL and an
epsilon MSE carry the gradient; the DDIM monitor's feature term and the two
SMPL-X vertex-displacement terms enter the total detached (the reference
computes them under ``torch.no_grad``).

Stage 1 mirrors ``AST_EVP._collect_metrics`` (``AST_EVP.py:260-325``): 16
L1 reconstruction terms, cross-entropy on the emotion and speaker logits,
and a content-alignment L1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from amuse_tpu_torch.models.vae import kl_divergence_normal


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """``torch.nn.SmoothL1Loss(reduction='mean')``: 0.5 d^2 / beta below beta,
    d - 0.5 beta above."""
    return F.smooth_l1_loss(pred, target, beta=beta)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss(reduction='mean')`` on int labels."""
    return F.cross_entropy(logits.float(), labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent (``AST_EVP.py:263-266`` convention)."""
    return 100.0 * (logits.argmax(-1) == labels).float().mean()


LAMBDA_KL = 1e-4  # configs/diff_latent_v2.json:75
LAMBDA_REC = 1.0
LAMBDA_GEN = 1.0


def lpdm_losses(
    m_ref: torch.Tensor,  # (B, T, F) reference motion features
    m_rst: torch.Tensor,  # VAE reconstruction
    mu: torch.Tensor,
    logvar: torch.Tensor,
    noise: torch.Tensor,
    noise_pred: torch.Tensor,
    gen_m_rst: Optional[torch.Tensor] = None,  # DDIM monitor decode
    rec_vertices: Optional[tuple] = None,  # (rst_verts, ref_verts)
    gen_vertices: Optional[tuple] = None,  # (gen_verts, ref_verts)
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Stage-2 objective -> (total, logs). The monitor terms change the total's
    value and carry no gradient."""
    rec = smooth_l1(m_rst, m_ref)
    kl = kl_divergence_normal(mu, logvar)
    inst = mse(noise_pred, noise)
    total = LAMBDA_REC * rec + LAMBDA_KL * kl + inst
    logs = {"recons_feature": rec, "kl_motion": kl, "inst_loss": inst}
    monitors = []
    if gen_m_rst is not None:
        logs["gen_feature"] = smooth_l1(gen_m_rst.detach(), m_ref.detach())
        monitors.append(LAMBDA_GEN * logs["gen_feature"])
    for name, pair in (("rec_vtex_displacement", rec_vertices),
                       ("gen_vtex_displacement", gen_vertices)):
        if pair is not None:
            logs[name] = smooth_l1(pair[0].detach(), pair[1].detach())
            monitors.append(logs[name])
    for term in monitors:
        total = total + term.detach()
    logs["total"] = total
    return total, logs


def ast_swap_losses(
    recon_fbanks: torch.Tensor,  # (16, B, T, F): [self x4 | con x4 | emo x4 | sty x4]
    clean_fbanks: torch.Tensor,  # (4, B, T, F): targets a1t1, a1t2, a2t1, a2t2
    emo_logits: torch.Tensor,  # (4, B, 8)
    sty_logits: torch.Tensor,  # (4, B, 30)
    con_features: torch.Tensor,  # (4, B, feature_dim)
    emo_id: torch.Tensor,  # (B,)
    a1_id: torch.Tensor,  # (B,) 0-based actor index
    a2_id: torch.Tensor,  # (B,)
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Stage-1 objective -> (total, logs). Each of the 4 swap groups maps its
    i-th output back to clean target i."""
    targets = clean_fbanks.repeat(4, 1, 1, 1)  # (16, B, T, F)
    rec_total = (recon_fbanks - targets).abs().mean(dim=(1, 2, 3)).sum()
    sty_labels = (a1_id, a1_id, a2_id, a2_id)
    ce_emo = sum(cross_entropy(emo_logits[i], emo_id) for i in range(4))
    ce_sty = sum(cross_entropy(sty_logits[i], sty_labels[i]) for i in range(4))
    con_align = l1(con_features[0], con_features[2]) + l1(con_features[1], con_features[3])
    total = rec_total + ce_emo + ce_sty + con_align
    logs = {
        "recon": rec_total,
        "ce_emo": ce_emo,
        "ce_sty": ce_sty,
        "con_align": con_align,
        "emo_acc": sum(accuracy(emo_logits[i], emo_id) for i in range(4)) / 4.0,
        "person_id_acc": sum(accuracy(sty_logits[i], sty_labels[i]) for i in range(4)) / 4.0,
        "total": total,
    }
    return total, logs
