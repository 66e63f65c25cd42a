"""Losses: masked / label-smoothed cross-entropy over dense logits.

Counterpart of ``transformers4rec_tpu/model/losses.py:cross_entropy_with_logits``.
Every loss is a weighted mean over static-shape inputs, ``sum(w·ce) / sum(w)``
with w = 0 at non-target positions. This dense form serves training with
``use_fused_ops=False`` and is the independent check of
``ops.vocab.fused_softmax_ce`` in the tests.

Not ported yet: the binary cross-entropy and the squared error of the binary
and regression tasks.
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
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)
