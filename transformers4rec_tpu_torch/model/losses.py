"""Losses: masked / label-smoothed cross-entropy over dense logits, the
binary cross-entropy and the squared error of the dense tasks.

Counterpart of ``transformers4rec_tpu/model/losses.py``. Every loss is a
weighted mean over static-shape inputs, ``sum(w·loss) / sum(w)`` with w = 0
at non-target positions (or rows that are all padding). The dense
cross-entropy serves training with ``use_fused_ops=False`` and sampled
softmax, and is the independent check of ``ops.vocab.fused_softmax_ce`` in
the tests.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_with_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Weighted-mean CE over integer labels. logits: (..., V); labels: (...,)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        # (1-eps)*nll + eps*mean(-log_probs): torch.nn.CrossEntropyLoss semantics
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return _weighted_mean(nll, weights)


def _weighted_mean(per: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return per.mean()
    w = weights.float()
    return (per * w).sum() / w.sum().clamp_min(1.0)


def binary_cross_entropy_with_logits(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Weighted-mean BCE on logits, in the reference's stable form
    ``max(z, 0) - z·y + log1p(exp(-|z|))``."""
    logits, labels = logits.float(), labels.float()
    per = logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return _weighted_mean(per, weights)


def mse_loss(
    preds: torch.Tensor, targets: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Weighted-mean squared error."""
    return _weighted_mean((preds.float() - targets.float()) ** 2, weights)
