"""Prediction tasks: next-item (tied or untied output, full or sampled
softmax), binary classification and regression.

Counterpart of ``transformers4rec_tpu/model/prediction_task.py``.
``NextItemPredictionTask`` runs the hidden states through its task blocks
(``task_block_{i}``, ReLU layers) and projects them (``tying_projection``)
to the width of its output weights: the item table itself
(``weight_tying=True``) or its own ``output_layer`` (target_dim, d_model).

Call modes of ``NextItemPredictionTask``:
- training: every position of the batch is a row; the rows that carry a
  target are gathered first into a static budget of M rows (a ≥6σ binomial
  bound on their number), and the fused softmax cross-entropy
  (``ops.vocab.fused_softmax_ce``, kernels K1 and K2) gives the loss without
  (M, V) logits; with ``use_fused_ops=False`` the dense logits go through
  ``losses.cross_entropy_with_logits``. With ``sampled_softmax`` the loss is
  instead a softmax over each row's positive and ``max_n_samples`` shared
  negatives, all B·S rows and no budget: ``LogUniformSampler`` draws the
  negatives from the step's generator (or ``MaskingInfo.neg_ids`` gives
  them), the scores are corrected by the log of each id's expected
  probability (logQ) and accidental hits masked. Under the sparse
  embedding step (``sparse_rows``) the label and negative rows come
  pre-gathered and the table is not read (``_sampled_scores``);
- testing (evaluation): one target per session, the last item
  (``eval_single_target``): its hidden state is gathered and the fused
  CE-and-rank pass (ops/vocab.py, kernel K3) gives the loss and the ranking
  metrics without (N, V) logits; or every position of the batch a row (the
  masking's ``eval_on_last_item_seq_only=False``), through the same pass
  over the B*S rows, the positions without a target weighted 0. Without
  metrics the fused cross-entropy (K1) gives the loss alone. With
  ``use_fused_ops=False`` both take dense f32 logits, the dense
  cross-entropy and ``ranking_metric.compute_batch_metrics``. Sampled
  softmax changes the training branch only: evaluation is full-catalogue;
- inference: the hidden state at the [MASK] position appended by MLM (the
  last item for other schemes) is scored against every item with one dense
  f32 product, then ``torch.topk``; above N·V = 1e9 the streamed
  ``ops.vocab.fused_topk`` takes over.

``BinaryClassificationTask`` and ``RegressionTask`` summarise the sequence
into one row per session (``PredictionTask.summarize``: the last non-padded
position, the first, the mean or the final position), run their task
blocks and an ``output`` layer of width 1, and give a weighted-mean BCE or
squared error with rows that are all padding weighted 0; their metrics are
exact streaming (sum, count) pairs: ``accuracy``, ``precision`` and
``recall``, or ``mse``.

``vocab_parallel_group`` (the counterpart of the reference's
``vocab_parallel_mesh``) is a ``torch.distributed`` process group over which
the tied table's rows are split (``Model`` shards the table when it is
built). The training loss, the evaluation and the top-k then run the
functions of ``parallel/sharded_embedding.py``: the kernels per shard and
O(N) numbers merged over the group. Top-k always takes ``sharded_topk``
there, in f32 at or below N·V = 1e9 and in bf16 above.

Not ported yet (raise ``NotImplementedError``): a vocab-parallel group with
sampled softmax or with an untied output layer, and with a group the dense
(non-fused) loss and inference without ``top_k``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..blocks.transformer import init_dense_, promote
from ..masking import MaskingInfo
from ..ops.sparse_update import GatheredRows
from ..ops.vocab import fused_ce_and_rank, fused_softmax_ce, fused_topk
from ..parallel.sharded_embedding import (
    sharded_ce_and_rank,
    sharded_softmax_ce,
    sharded_topk,
)
from .losses import binary_cross_entropy_with_logits, cross_entropy_with_logits, mse_loss
from .ranking_metric import (
    DEFAULT_METRICS,
    RankingMetric,
    compute_batch_metrics,
    metrics_from_ranks,
)

_STREAMED_TOPK_MIN = 1_000_000_000  # N·V above which the reference streams top-k


class LogUniformSampler:
    """Log-uniform (Zipf) negative sampler over ids ``[min_id, max_id)``,
    which assumes ids sorted by decreasing frequency:
    ``P(r) = log1p(1 / (r + 1)) / log(range + 1)`` at ``r = id - min_id``.

    ``sample`` draws a fixed ``max_n_samples`` ids with replacement (static
    shapes, no ``unique``) by the inverse CDF; ``expected_probs`` is the
    probability that an id is drawn at least once in those tries, the logQ
    correction of the sampled scores."""

    def __init__(self, max_n_samples: int, max_id: int, min_id: int = 0):
        if max_id <= 0:
            raise ValueError("max_id must be a positive integer.")
        if max_n_samples <= 0:
            raise ValueError("max_n_samples must be a positive integer.")
        self.max_n_samples = max_n_samples
        self.max_id = max_id
        self.min_id = min_id
        self.range = max_id - min_id

    def _log_range(self, device) -> torch.Tensor:
        # log(range + 1) taken in float32, as the reference takes it; a fill
        # on the device, where a tensor of a host value would be a copy that
        # waits for the device's queue
        return torch.log(torch.full((), self.range + 1.0, dtype=torch.float32, device=device))

    def probs(self, ids: torch.Tensor) -> torch.Tensor:
        """The pmf at ``ids``. ``log(r + 2) - log(r + 1)`` is written
        ``log1p(1 / (r + 1))``: the difference of two logs near 13 cancels in
        float32 and can round negative for large ids, and the logQ correction
        then takes the log of a negative number."""
        rel = (ids - self.min_id).clamp(0, self.range - 1).float()
        p = torch.log1p(1.0 / (rel + 1.0)) / self._log_range(ids.device)
        return torch.where(ids >= self.min_id, p, torch.zeros_like(p))

    def expected_probs(self, ids: torch.Tensor) -> torch.Tensor:
        """P(an id is drawn at least once in n tries) = ``-expm1(n·log1p(-p))``."""
        return -torch.expm1(self.max_n_samples * torch.log1p(-self.probs(ids)))

    def sample(self, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
        """``max_n_samples`` ids (long) by the inverse CDF
        ``floor(exp(u·log(range + 1))) - 1``, ``u`` uniform from
        ``generator`` (on ``device``). The cast truncates as the reference's
        ``astype(int32)`` does; the clip keeps the float32 rounding of
        ``exp`` near ``range`` inside it."""
        if generator is not None:
            device = generator.device
        u = torch.rand(self.max_n_samples, generator=generator, device=device)
        ids = torch.exp(u * self._log_range(u.device)).to(torch.int32) - 1
        return ids.clamp(0, self.range - 1).long() + self.min_id


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


def build_task_blocks(task: nn.Module, d_in: int) -> int:
    """Add the ReLU layers of ``task.task_block_dims`` to ``task`` under
    flax's names (``task_block_{i}``); returns their output width."""
    for i, d in enumerate(task.task_block_dims):
        task.add_module(f"task_block_{i}", nn.Linear(d_in, d))
        d_in = d
    return d_in


def task_blocks(task: nn.Module, x: torch.Tensor) -> torch.Tensor:
    for i in range(len(task.task_block_dims)):
        x = torch.relu(getattr(task, f"task_block_{i}")(x))
    return x


class PredictionTask(nn.Module):
    """Base of the dense tasks: task blocks and the sequence summary that
    turns (B, S, D) hidden states into one (B, D) row per session."""

    def __init__(self, target_name: Optional[str] = None, task_name: str = "task",
                 summary_type: str = "last", task_block_dims: Sequence[int] = ()):
        super().__init__()
        if summary_type not in ("last", "first", "mean", "cls_index"):
            raise ValueError(f"unknown summary_type {summary_type!r}")
        self.target_name = target_name
        self.task_name = task_name
        self.summary_type = summary_type
        self.task_block_dims = tuple(task_block_dims)

    def build(self, d_in: int) -> None:
        """The task blocks and the ``output`` layer for a body of width
        ``d_in``."""
        self.output = nn.Linear(build_task_blocks(self, d_in), 1)

    def _init_weights(self, generator: torch.Generator) -> None:
        for child in self.children():
            if isinstance(child, nn.Linear):
                init_dense_(child, generator)

    def summarize(self, hidden: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, S, D) → (B, D): ``last`` the last non-padded position,
        ``first`` position 0, ``mean`` the mean over non-padded positions,
        ``cls_index`` the final position whatever the padding."""
        if hidden.dim() == 2:
            return hidden
        S = hidden.shape[1]
        if self.summary_type == "first":
            return hidden[:, 0]
        if self.summary_type == "cls_index":
            return hidden[:, -1]
        if self.summary_type == "mean":
            if pad_mask is None:
                return hidden.mean(dim=1)
            w = pad_mask[..., :S].to(hidden.dtype)
            return (hidden * w[..., None]).sum(1) / w.sum(1, keepdim=True).clamp_min(1.0)
        if pad_mask is None:
            last = torch.full((hidden.shape[0],), S - 1, device=hidden.device)
        else:
            last = (pad_mask[..., :S].sum(dim=1) - 1).clamp_min(0)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]

    def _prepare(self, hidden, targets, pad_mask):
        """The output layer's (B,) values and, with targets, the float
        targets and each row's validity: a row that is all padding (a
        zero-filled tail row) carries no loss or metric weight."""
        x = task_blocks(self, self.summarize(hidden, pad_mask).float())
        out = self.output(x)[..., 0]
        if targets is None:
            return out, None, None
        targets = targets.float()
        if pad_mask is not None and pad_mask.dim() == 2:
            valid = pad_mask.any(dim=1).float()
        else:
            valid = torch.ones(targets.shape[0], device=targets.device)
        return out, targets, valid


class BinaryClassificationTask(PredictionTask):
    """BCE on one logit per session; streaming accuracy, precision and
    recall at the threshold 0.5."""

    def __init__(self, target_name: Optional[str] = None,
                 task_name: str = "binary_classification", summary_type: str = "last",
                 task_block_dims: Sequence[int] = ()):
        super().__init__(target_name, task_name, summary_type, task_block_dims)

    def forward(self, hidden, targets=None, pad_mask=None, training: bool = False,
                testing: bool = False) -> TaskOutput:
        logits, targets, valid = self._prepare(hidden, targets, pad_mask)
        preds = torch.sigmoid(logits)
        if targets is None:
            return TaskOutput(loss=torch.zeros((), device=logits.device), predictions=preds)
        loss = binary_cross_entropy_with_logits(logits, targets, weights=valid)
        hard = (preds > 0.5).float()
        tp = (hard * targets * valid).sum()
        # exact (sum, count) states: batches of any size merge by addition;
        # bare names, the collector prefixes the task's name
        metrics = {"accuracy": (((hard == targets).float() * valid).sum(), valid.sum()),
                   "precision": (tp, (hard * valid).sum()),
                   "recall": (tp, (targets * valid).sum())}
        return TaskOutput(loss=loss, labels=targets, predictions=preds, metrics=metrics,
                          loss_weight=valid.sum())


class RegressionTask(PredictionTask):
    """Squared error on one value per session; streaming ``mse``."""

    def __init__(self, target_name: Optional[str] = None, task_name: str = "regression",
                 summary_type: str = "last", task_block_dims: Sequence[int] = ()):
        super().__init__(target_name, task_name, summary_type, task_block_dims)

    def forward(self, hidden, targets=None, pad_mask=None, training: bool = False,
                testing: bool = False) -> TaskOutput:
        preds, targets, valid = self._prepare(hidden, targets, pad_mask)
        if targets is None:
            return TaskOutput(loss=torch.zeros((), device=preds.device), predictions=preds)
        loss = mse_loss(preds, targets, weights=valid)
        sq = ((preds - targets) ** 2 * valid).sum()
        return TaskOutput(loss=loss, labels=targets, predictions=preds,
                          metrics={"mse": (sq, valid.sum())}, loss_weight=valid.sum())


class NextItemPredictionTask(nn.Module):
    """Next-item prediction over the item table or an untied output layer."""

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
        max_n_samples: int = 100,
        min_id: int = 1,
        loss_budget: Optional[float] = None,
        budget_target_prob: Optional[float] = None,
        vocab_parallel_group: Optional[Any] = None,
    ):
        super().__init__()
        if vocab_parallel_group is not None and sampled_softmax:
            raise NotImplementedError(
                "sampled softmax over a vocab-parallel group (the sharded row gather) "
                "is not ported yet")
        if vocab_parallel_group is not None and not weight_tying:
            raise NotImplementedError("a vocab-parallel group needs the tied item table")
        self.task_name = task_name
        self.weight_tying = weight_tying
        self.softmax_temperature = softmax_temperature
        self.padding_idx = padding_idx
        self.target_dim = target_dim
        self.label_smoothing = label_smoothing
        self.task_block_dims = tuple(task_block_dims)
        self.metrics = tuple(metrics)
        self.eval_single_target = eval_single_target
        self.use_fused_ops = use_fused_ops
        # sampled softmax (training only): max_n_samples log-uniform
        # negatives over ids [min_id, target_dim) shared by every row
        self.sampled_softmax = sampled_softmax
        self.max_n_samples = max_n_samples
        self.min_id = min_id
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
        self.output_layer: Optional[nn.Parameter] = None

    def __deepcopy__(self, memo):
        # a process group is shared between copies of a task, never copied
        if self.vocab_parallel_group is not None:
            memo[id(self.vocab_parallel_group)] = self.vocab_parallel_group
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return new

    def build(self, d_in: int, item_dim: Optional[int] = None) -> None:
        """Create the weights for a body of width ``d_in``: the task blocks
        (``task_block_{i}``), the untied ``output_layer`` (target_dim, d_in)
        without weight tying, and the projection from the blocks' width to
        the output weights' width (the item table's ``item_dim``, or
        ``d_in``), none when they are equal."""
        out_dim = item_dim
        if not self.weight_tying:
            if self.target_dim is None:
                raise ValueError("target_dim is required when weight_tying=False")
            self.output_layer = nn.Parameter(torch.empty(self.target_dim, d_in))
            out_dim = d_in
        width = build_task_blocks(self, d_in)
        self.tying_projection = (
            nn.Linear(width, out_dim, bias=False) if width != out_dim else None
        )

    def _init_weights(self, generator: torch.Generator) -> None:
        for i in range(len(self.task_block_dims)):
            init_dense_(getattr(self, f"task_block_{i}"), generator)
        if self.tying_projection is not None:
            init_dense_(self.tying_projection, generator)
        if self.output_layer is not None:
            # flax's variance_scaling(1/3, "fan_in", "uniform"): a 2-D
            # weight's fan-in is its first axis, so the bound is
            # sqrt(3 · (1/3) / target_dim)
            bound = (1.0 / self.output_layer.shape[0]) ** 0.5
            nn.init.uniform_(self.output_layer, -bound, bound, generator=generator)

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        x = task_blocks(self, x)
        return self.tying_projection(x) if self.tying_projection is not None else x

    def make_sampler(self, vocab_rows: int) -> LogUniformSampler:
        """The task's negative sampler: ids ``[min_id, target_dim)``."""
        return LogUniformSampler(self.max_n_samples, self.target_dim or vocab_rows, self.min_id)

    def _sampled_logits(self, x2d, labels, W, generator, neg_ids=None):
        """(N, 1 + n) logits, the positive first, for labels of 0: the rows
        of x2d scored against their label's row of W and the n negatives'.
        ``neg_ids`` replaces the draw from ``generator``."""
        sampler = self.make_sampler(W.shape[0])
        if neg_ids is None:
            neg_ids = sampler.sample(generator, device=x2d.device)
        neg_ids = neg_ids.to(x2d.device).long()
        return self._sampled_scores(x2d, labels, W[labels], W[neg_ids], neg_ids, sampler)

    def _sampled_scores(self, x2d, labels, pos_w, neg_w, neg_ids, sampler):
        """The logits of ``_sampled_logits`` from the rows already gathered:
        ``pos_w`` (N, E) the labels', ``neg_w`` (n, E) the negatives'. The
        temperature divides the raw scores only, before the logQ correction
        (dividing the corrected logits would scale the correction too)."""
        temp = self.softmax_temperature or 1.0
        # rows of a bf16-stored table are scored in f32, as the reference
        # promotes them
        pos = (x2d * pos_w).sum(-1, keepdim=True) / temp
        neg = (x2d @ promote(neg_w, x2d).T) / temp
        eps = 1e-16
        pos = pos - torch.log(sampler.expected_probs(labels) + eps)[:, None]
        neg = neg - torch.log(sampler.expected_probs(neg_ids) + eps)[None, :]
        # accidental hits: a negative that is the row's own label
        neg = torch.where(labels[:, None] == neg_ids[None, :], -1e4, neg)
        return torch.cat([pos, neg], dim=1)

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
        generator: Optional[torch.Generator] = None,
        sparse_rows: Optional[GatheredRows] = None,
    ):
        """``generator`` feeds the negative draw of sampled softmax in
        training. ``sparse_rows`` (the sparse step's pre-gathered rows of the
        tied table) gives the sampled softmax its label and negative rows:
        the table itself is then not read."""
        if info is None:
            raise ValueError("NextItemPredictionTask requires a masking-enabled input module")
        if self.output_layer is not None:
            W = self.output_layer
        elif info.item_table is None:
            raise ValueError("weight tying needs the item table in MaskingInfo.item_table")
        else:
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

        if training and self.sampled_softmax:
            # every position a row, no budget: the targets' rows score
            # against one shared set of negatives
            N = info.targets.shape[0] * info.targets.shape[1]
            labels = info.targets.reshape(N).long()
            w = info.mask.reshape(N).float()
            if sparse_rows is not None:
                r = sparse_rows
                logits = self._sampled_scores(x.reshape(N, -1), labels, r.rows[r.pos_map],
                                              r.rows[r.neg_base:], r.neg_ids,
                                              self.make_sampler(W.shape[0]))
            else:
                logits = self._sampled_logits(x.reshape(N, -1), labels, W, generator,
                                              neg_ids=info.neg_ids)
            loss = cross_entropy_with_logits(
                logits, torch.zeros_like(labels), weights=w,
                label_smoothing=self.label_smoothing)
            return TaskOutput(loss=loss, labels=labels, weights=w, loss_weight=w.sum())

        if testing and self.eval_single_target and info.segment_ids is None:
            # one target per session: gather that position (packed rows carry
            # one per segment and take the full-position path below)
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
            if not training and info.targets_per_segment_bounded:
                # packed evaluation: at most one target per segment of two or
                # more items, so at most S // 2 a row: B·(S//2) rows hold
                # every target, exactly
                B_, S_ = targets.shape
                M = min(N, max(B_ * (S_ // 2), 1))
            if M is not None:
                # a stable argsort puts the target positions first; in
                # training, overflow beyond M (a ≥6σ margin) would drop a few
                # targets
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
