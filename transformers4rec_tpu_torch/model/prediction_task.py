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
- testing (evaluation): one target per session, the last item
  (``eval_single_target``): its hidden state is gathered and the fused
  CE-and-rank pass (ops/vocab.py, kernel K3) gives the loss and the ranking
  metrics without (N, V) logits; or every position of the batch a row (the
  masking's ``eval_on_last_item_seq_only=False``), through the same pass
  over the B*S rows, the positions without a target weighted 0. Without
  metrics the fused cross-entropy (K1) gives the loss alone. With
  ``use_fused_ops=False`` both take dense f32 logits, the dense
  cross-entropy and ``ranking_metric.compute_batch_metrics``;
- inference: the hidden state at the [MASK] position appended by MLM (the
  last item for other schemes) is scored against every item with one dense
  f32 product, then ``torch.topk``; above N·V = 1e9 the streamed
  ``ops.vocab.fused_topk`` takes over.

``vocab_parallel_group`` (the counterpart of the reference's
``vocab_parallel_mesh``) is a ``torch.distributed`` process group over which
the tied table's rows are split (``Model`` shards the table when it is
built). The training loss, the evaluation and the top-k then run the
functions of ``parallel/sharded_embedding.py``: the kernels per shard and
O(N) numbers merged over the group. Top-k always takes ``sharded_topk``
there, in f32 at or below N·V = 1e9 and in bf16 above.

Not ported yet (raise ``NotImplementedError``): sampled softmax, an untied
output layer, task blocks, and with a group the dense (non-fused) loss and
inference without ``top_k``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..masking import MaskingInfo
from ..ops.vocab import fused_ce_and_rank, fused_softmax_ce, fused_topk
from ..parallel.sharded_embedding import (
    sharded_ce_and_rank,
    sharded_softmax_ce,
    sharded_topk,
)
from .losses import cross_entropy_with_logits
from .ranking_metric import (
    DEFAULT_METRICS,
    RankingMetric,
    compute_batch_metrics,
    metrics_from_ranks,
)

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
        vocab_parallel_group: Optional[Any] = None,
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
        # vocab-parallel softmax: the process group over which the tied
        # table's rows are split
        self.vocab_parallel_group = vocab_parallel_group
        self.tying_projection: Optional[nn.Linear] = None

    def __deepcopy__(self, memo):
        # a process group is shared between copies of a task, never copied
        if self.vocab_parallel_group is not None:
            memo[id(self.vocab_parallel_group)] = self.vocab_parallel_group
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return new

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

    def _vocab_ce(self, x2d, W, labels, weights, vsz) -> torch.Tensor:
        """Streamed full-softmax CE, vocab-parallel when a group is set."""
        if self.vocab_parallel_group is not None:
            return sharded_softmax_ce(x2d, W, labels, weights, self.vocab_parallel_group,
                                      vocab_size=vsz, label_smoothing=self.label_smoothing)
        return fused_softmax_ce(x2d, W, labels, weights, vocab_size=vsz,
                                label_smoothing=self.label_smoothing)

    def _vocab_ce_rank(self, x2d, W, labels, weights, vsz):
        """Streamed evaluation CE and label ranks, vocab-parallel when a
        group is set."""
        if self.vocab_parallel_group is not None:
            return sharded_ce_and_rank(x2d, W, labels, weights, self.vocab_parallel_group,
                                       vocab_size=vsz, label_smoothing=self.label_smoothing)
        return fused_ce_and_rank(x2d, W, labels, weights, vocab_size=vsz,
                                 label_smoothing=self.label_smoothing)

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
        group = self.vocab_parallel_group
        table_rows = W.shape[0]  # of the whole table: W is one shard of a group's
        if group is not None:
            table_rows *= dist.get_world_size(group)
        # true vocab when the table carries padding rows
        vsz = self.target_dim if (self.target_dim and self.target_dim != table_rows) else None
        rows = torch.arange(x.shape[0], device=x.device)

        if (training or testing) and not self.use_fused_ops and group is not None:
            raise NotImplementedError("a vocab-parallel group needs use_fused_ops")

        def dense_logits(h):
            logits = (h @ W.float().T) / temp
            return logits if vsz is None else logits[..., :vsz]

        if testing and self.eval_single_target:
            # one target per session: gather that position
            idx = torch.argmax(info.mask.to(torch.int32), dim=1)
            row_valid = info.mask.any(dim=1).float()
            xg = x[rows, idx]
            labels = info.targets[rows, idx]
            metrics = None
            if not self.use_fused_ops:
                logits = dense_logits(xg)
                loss = cross_entropy_with_logits(logits, labels, weights=row_valid,
                                                 label_smoothing=self.label_smoothing)
                if compute_metrics:
                    metrics = compute_batch_metrics(logits, labels, self.metrics,
                                                    weights=row_valid)
                return TaskOutput(loss=loss, labels=labels, predictions=logits,
                                  weights=row_valid, metrics=metrics,
                                  loss_weight=row_valid.sum())
            if compute_metrics:
                loss, rank = self._vocab_ce_rank(xg / temp, W, labels, row_valid, vsz)
                metrics = metrics_from_ranks(rank, self.metrics, weights=row_valid)
            else:
                loss = self._vocab_ce(xg / temp, W, labels.to(torch.int32), row_valid, vsz)
            return TaskOutput(loss=loss, labels=labels, weights=row_valid,
                              metrics=metrics, loss_weight=row_valid.sum())

        if training or testing:
            # full-position path over the B*S rows
            targets = info.targets
            N = targets.shape[0] * targets.shape[1]
            flat_labels = targets.reshape(N)
            flat_mask = info.mask.reshape(N).float()
            metrics = None
            if not self.use_fused_ops:
                logits = dense_logits(x)
                loss = cross_entropy_with_logits(logits, targets, weights=info.mask.float(),
                                                 label_smoothing=self.label_smoothing)
                flat_logits = logits.reshape(N, -1)
                if compute_metrics and testing:
                    metrics = compute_batch_metrics(flat_logits, flat_labels, self.metrics,
                                                    weights=flat_mask)
                return TaskOutput(loss=loss, labels=flat_labels,
                                  predictions=flat_logits if testing else None,
                                  weights=flat_mask, metrics=metrics,
                                  loss_weight=flat_mask.sum())
            x2d = x.reshape(N, -1) / temp
            M = self._budget_rows(N) if training else None
            if M is not None:
                # a stable argsort puts the target positions first; overflow
                # beyond M (a ≥6σ margin) would drop a few targets
                order = torch.argsort(flat_mask <= 0, stable=True)[:M]
                x2d, flat_labels, flat_mask = x2d[order], flat_labels[order], flat_mask[order]
            labels = flat_labels.to(torch.int32)
            if compute_metrics and testing:
                # every position: one streamed pass for the loss and the ranks
                loss, rank = self._vocab_ce_rank(x2d, W, labels, flat_mask, vsz)
                metrics = metrics_from_ranks(rank, self.metrics, weights=flat_mask)
            else:
                loss = self._vocab_ce(x2d, W, labels, flat_mask, vsz)
            return TaskOutput(loss=loss, labels=labels, weights=flat_mask, metrics=metrics,
                              loss_weight=flat_mask.sum())

        # inference: score the next item of every session
        item_ids = info.item_ids
        non_pad = (item_ids != self.padding_idx).sum(dim=1)
        # MLM appended a [MASK] at index len (the pad mask is one wider)
        extended = info.pad_mask is not None and info.pad_mask.shape[1] > item_ids.shape[1]
        last_idx = (non_pad if extended else non_pad - 1).clamp(0, x.shape[1] - 1)
        xg = x[rows, last_idx]
        small = xg.shape[0] * table_rows <= _STREAMED_TOPK_MIN
        if group is not None:
            if top_k is None:
                raise NotImplementedError(
                    "a vocab-parallel group serves top-k only: the scores of a sharded "
                    "table are not gathered"
                )
            # the local top-k per shard and a merge of the candidates; the
            # compute type is the unsharded route's choice at the same size
            return sharded_topk(xg / temp, W, top_k, group, vocab_size=vsz,
                                compute_dtype=torch.float32 if small else None)
        if top_k is not None and self.use_fused_ops and not small:
            # huge N·V: the streamed top-k merge (peak memory O(N·chunk))
            return fused_topk(xg / temp, W, top_k, vocab_size=vsz)
        scores = (xg @ W.float().T) / temp
        if vsz is not None:
            scores = scores[:, :vsz]
        if top_k is None:
            return scores
        values, ids = torch.topk(scores, top_k, dim=-1)
        return values, ids
