"""Stage-1 classification statistics (port of ``amuse_tpu/eval/classification.py``).

Accuracy, macro precision and recall, and micro F1 from a confusion matrix
over the epoch's collected logits, as the reference's ``calculate_stats``
(``AST_EVP.py:331-430``, torchmetrics) reports them.
"""

from __future__ import annotations

import torch


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N,) int preds and labels -> (C, C) counts [true, pred]."""
    idx = labels.long() * num_classes + preds.long()
    return torch.bincount(idx, minlength=num_classes * num_classes).view(num_classes, num_classes)


def classification_stats(logits: torch.Tensor, labels: torch.Tensor,
                         num_classes: int) -> dict[str, torch.Tensor]:
    """-> {acc (percent), precision_macro, recall_macro, f1_micro}."""
    cm = confusion_matrix(logits.argmax(-1), labels, num_classes).float()
    tp = cm.diagonal()
    per_pred, per_true = cm.sum(0), cm.sum(1)
    precision = torch.where(per_pred > 0, tp / per_pred.clamp(min=1), 0.0)
    recall = torch.where(per_true > 0, tp / per_true.clamp(min=1), 0.0)
    acc = tp.sum() / cm.sum().clamp(min=1)
    # micro-F1 over all classes equals accuracy for single-label problems
    return {"acc": 100.0 * acc, "precision_macro": precision.mean(),
            "recall_macro": recall.mean(), "f1_micro": acc}


def epoch_stats(emo_logits: torch.Tensor, emo_labels: torch.Tensor,
                sty_logits: torch.Tensor, sty_labels: torch.Tensor) -> dict[str, dict[str, float]]:
    """The reference's end-of-epoch stats dict {emo_stats, subject_stats}."""
    emo = classification_stats(emo_logits, emo_labels, 8)
    sty = classification_stats(sty_logits, sty_labels, 30)
    return {"emo_stats": {k: float(v) for k, v in emo.items()},
            "subject_stats": {k: float(v) for k, v in sty.items()}}
