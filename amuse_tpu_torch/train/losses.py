"""Stage-1 losses (port of the stage-1 part of ``amuse_tpu/train/losses.py``).

The objective mirrors the reference ``AST_EVP._collect_metrics``
(``AST_EVP.py:260-325``): 16 L1 reconstruction terms, cross-entropy on the
emotion and speaker logits, and a content-alignment L1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss(reduction='mean')`` on int labels."""
    return F.cross_entropy(logits.float(), labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent (``AST_EVP.py:263-266`` convention)."""
    return 100.0 * (logits.argmax(-1) == labels).float().mean()


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
