"""Next-item prediction with a tied item table.

Counterpart of ``transformers4rec_tpu/model/prediction_task.py:
NextItemPredictionTask``. Hidden states are projected to the item-table
width (``tying_projection``) and scored against the item table itself.

Call modes:
- training: every position of the batch is a row; the rows that carry a
  target are gathered first into a static budget of M rows (a ≥6σ binomial
  bound on their number), and the fused softmax cross-entropy
  (``ops.vocab.fused_softmax_ce``, kernels K1 and K2) gives the loss without
  (M, V) logits; with ``use_fused_ops=False`` the dense logits go through
  ``losses.cross_entropy_with_logits``;
- testing (evaluation): one target per session, the last item; its hidden
  state is gathered and the fused CE-and-rank pass (ops/vocab.py, kernel
  K3) gives the loss and the ranking metrics without (N, V) logits;
- inference: the hidden state at the [MASK] position appended by MLM (the
  last item for other schemes) is scored against every item with one dense
  f32 product, then ``torch.topk``.

Not ported yet (raise ``NotImplementedError``): sampled softmax, the
vocab-parallel mesh, evaluation on every position, the non-fused evaluation
path, an untied output layer, task blocks, and the
streamed top-k the reference takes above N·V = 1e9.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..masking import MaskingInfo
from ..ops.vocab import fused_ce_and_rank, fused_softmax_ce
from .losses import cross_entropy_with_logits
from .ranking_metric import DEFAULT_METRICS, RankingMetric, metrics_from_ranks

_STREAMED_TOPK_MIN = 1_000_000_000  # N·V above which the reference streams top-k


@dataclasses.dataclass
class TaskOutput:
    """What a task returns at evaluation time."""

    loss: torch.Tensor
    labels: Optional[torch.Tensor] = None
    predictions: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None  # per-row validity for metrics
    metrics: Optional[Dict[str, Any]] = None
    # scalar Σw, the denominator of the weighted-mean loss: evaluation loops
    # accumulate (loss·loss_weight, loss_weight) for an exact dataset mean
    loss_weight: Optional[torch.Tensor] = None


class NextItemPredictionTask(nn.Module):
    """Next-item prediction over a tied item table."""

    def __init__(
        self,
        task_name: str = "next-item",
        weight_tying: bool = False,
        softmax_temperature: float = 1.0,
        padding_idx: int = 0,
        target_dim: Optional[int] = None,
        label_smoothing: float = 0.0,
        task_block_dims: Sequence[int] = (),
        metrics: Tuple[RankingMetric, ...] = DEFAULT_METRICS,
        eval_single_target: bool = True,
        use_fused_ops: bool = True,
        sampled_softmax: bool = False,
        loss_budget: Optional[float] = None,
        budget_target_prob: Optional[float] = None,
    ):
        super().__init__()
        if sampled_softmax:
            raise NotImplementedError("sampled softmax is not ported yet")
        if not weight_tying:
            raise NotImplementedError("an untied output layer is not ported yet")
        if task_block_dims:
            raise NotImplementedError("task blocks are not ported yet")
        self.task_name = task_name
        self.weight_tying = weight_tying
        self.softmax_temperature = softmax_temperature
        self.padding_idx = padding_idx
        self.target_dim = target_dim
        self.label_smoothing = label_smoothing
        self.metrics = tuple(metrics)
        self.eval_single_target = eval_single_target
        self.use_fused_ops = use_fused_ops
        # loss-position budget: at train time the target-carrying positions
        # are gathered into M static rows before the vocab CE. An explicit
        # fraction of B*S, or None
        self.loss_budget = loss_budget
        # adaptive budget (set by Head.from_body from the masking's
        # mlm_probability): M = N·p + 6·sqrt(N·p·(1−p)) + 8; targets beyond M
        # (probability < 1e-9) drop
        self.budget_target_prob = budget_target_prob
        self.tying_projection: Optional[nn.Linear] = None

    def build(self, d_in: int, item_dim: int) -> None:
        """Create the projection from the body width to the item-table width
        (none when they are equal)."""
        self.tying_projection = (
            nn.Linear(d_in, item_dim, bias=False) if d_in != item_dim else None
        )

    def _init_weights(self, generator: torch.Generator) -> None:
        if self.tying_projection is not None:
            fan_in = self.tying_projection.in_features
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # flax lecun_normal
            nn.init.trunc_normal_(self.tying_projection.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)

    def _budget_rows(self, N: int) -> Optional[int]:
        """Rows the training CE runs on, or None for all N."""
        if self.loss_budget is not None:
            if self.loss_budget >= 1.0:
                return None
            return max(int(N * self.loss_budget), 1)
        p = self.budget_target_prob
        if p is None or p <= 0 or p >= 0.5:
            return None
        m = int(N * p + 6.0 * math.sqrt(N * p * (1.0 - p))) + 8
        return m if m < N else None

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        return self.tying_projection(x) if self.tying_projection is not None else x

    def forward(
        self,
        hidden: torch.Tensor,
        info: Optional[MaskingInfo] = None,
        training: bool = False,
        testing: bool = False,
        top_k: Optional[int] = None,
        compute_metrics: bool = True,
    ):
        if info is None:
            raise ValueError("NextItemPredictionTask requires a masking-enabled input module")
        if info.item_table is None:
            raise ValueError("weight tying needs the item table in MaskingInfo.item_table")
        W = info.item_table
        x = self._project(hidden.float())
        temp = self.softmax_temperature or 1.0
        # true vocab when the table carries padding rows
        vsz = self.target_dim if (self.target_dim and self.target_dim != W.shape[0]) else None
        rows = torch.arange(x.shape[0], device=x.device)

        if training:
            # full-position path over the B*S rows
            targets = info.targets
            N = targets.shape[0] * targets.shape[1]
            flat_mask = info.mask.reshape(N).float()
            if not self.use_fused_ops:
                logits = (x @ W.float().T) / temp
                if vsz is not None:
                    logits = logits[..., :vsz]
                loss = cross_entropy_with_logits(logits, targets, weights=info.mask.float(),
                                                 label_smoothing=self.label_smoothing)
                return TaskOutput(loss=loss, labels=targets.reshape(N), weights=flat_mask,
                                  loss_weight=flat_mask.sum())
            x2d = x.reshape(N, -1) / temp
            flat_labels = targets.reshape(N)
            M = self._budget_rows(N)
            if M is not None:
                # a stable argsort puts the target positions first; overflow
                # beyond M (a ≥6σ margin) would drop a few targets
                order = torch.argsort(flat_mask <= 0, stable=True)[:M]
                x2d, flat_labels, flat_mask = x2d[order], flat_labels[order], flat_mask[order]
            labels = flat_labels.to(torch.int32)
            loss = fused_softmax_ce(x2d, W, labels, flat_mask, vocab_size=vsz,
                                    label_smoothing=self.label_smoothing)
            return TaskOutput(loss=loss, labels=labels, weights=flat_mask,
                              loss_weight=flat_mask.sum())
        if testing:
            if not (self.eval_single_target and info.segment_ids is None
                    and self.use_fused_ops and compute_metrics):
                raise NotImplementedError(
                    "only the fused single-target evaluation path is ported"
                )
            # one target per session: gather that position
            idx = torch.argmax(info.mask.to(torch.int32), dim=1)
            row_valid = info.mask.any(dim=1).float()
            xg = x[rows, idx]
            labels = info.targets[rows, idx]
            loss, rank = fused_ce_and_rank(
                xg / temp, W, labels, row_valid, vocab_size=vsz,
                label_smoothing=self.label_smoothing,
            )
            metrics = metrics_from_ranks(rank, self.metrics, weights=row_valid)
            return TaskOutput(loss=loss, labels=labels, weights=row_valid,
                              metrics=metrics, loss_weight=row_valid.sum())

        # inference: score the next item of every session
        item_ids = info.item_ids
        non_pad = (item_ids != self.padding_idx).sum(dim=1)
        # MLM appended a [MASK] at index len (the pad mask is one wider)
        extended = info.pad_mask is not None and info.pad_mask.shape[1] > item_ids.shape[1]
        last_idx = (non_pad if extended else non_pad - 1).clamp(0, x.shape[1] - 1)
        xg = x[rows, last_idx]
        if top_k is not None and self.use_fused_ops and xg.shape[0] * W.shape[0] > _STREAMED_TOPK_MIN:
            raise NotImplementedError("the streamed top-k (fused_topk) is not ported yet")
        scores = (xg @ W.float().T) / temp
        if vsz is not None:
            scores = scores[:, :vsz]
        if top_k is None:
            return scores
        values, ids = torch.topk(scores, top_k, dim=-1)
        return values, ids
