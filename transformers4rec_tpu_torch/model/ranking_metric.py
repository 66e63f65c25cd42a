"""Streaming ranking metrics: NDCG / Recall / Precision / MAP / DCG / MRR @k.

Counterpart of ``transformers4rec_tpu/model/ranking_metric.py``. Metrics
are computed from the RANK of each label (0-based count of items scored
above it, from the fused eval pass; from dense scores, its place in their
top max(k): ``label_ranks``) and stream as ``(sum, count)`` pairs that
merge by addition. Every metric is weight-aware: rows with weight 0
count for nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

MetricState = Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # name -> (sum, count)


@dataclasses.dataclass(frozen=True)
class RankingMetric:
    """A rank→score rule evaluated at several cutoffs. ``from_rank(rank, k)``
    is the per-example value for a 0-based label rank (rank ≥ k: not in the
    top k)."""

    name: str = "metric"
    top_ks: Sequence[int] = (10, 20)

    def from_rank(self, rank: torch.Tensor, k: int) -> torch.Tensor:
        raise NotImplementedError

    def key(self, k: int) -> str:
        return f"{self.name}_at_{k}"


@dataclasses.dataclass(frozen=True)
class PrecisionAt(RankingMetric):
    """Single relevant item: hit / k."""

    name: str = "precision"

    def from_rank(self, rank, k):
        return (rank < k).float() / k


@dataclasses.dataclass(frozen=True)
class RecallAt(RankingMetric):
    name: str = "recall"

    def from_rank(self, rank, k):
        return (rank < k).float()


@dataclasses.dataclass(frozen=True)
class AvgPrecisionAt(RankingMetric):
    """Single-label AP@k = 1 / (rank + 1)."""

    name: str = "avg_precision"

    def from_rank(self, rank, k):
        return torch.where(rank < k, 1.0 / (rank.float() + 1.0), 0.0)


@dataclasses.dataclass(frozen=True)
class DCGAt(RankingMetric):
    """log2 discount."""

    name: str = "dcg"

    def from_rank(self, rank, k):
        return torch.where(rank < k, 1.0 / torch.log2(rank.float() + 2.0), 0.0)


@dataclasses.dataclass(frozen=True)
class NDCGAt(RankingMetric):
    """Ideal DCG for one relevant item is 1."""

    name: str = "ndcg"

    def from_rank(self, rank, k):
        return torch.where(rank < k, 1.0 / torch.log2(rank.float() + 2.0), 0.0)


@dataclasses.dataclass(frozen=True)
class MeanReciprocalRankAt(RankingMetric):
    name: str = "mrr"

    def from_rank(self, rank, k):
        return torch.where(rank < k, 1.0 / (rank.float() + 1.0), 0.0)


DEFAULT_METRICS: Tuple[RankingMetric, ...] = (
    NDCGAt(top_ks=(10, 20)),
    AvgPrecisionAt(top_ks=(10, 20)),
    RecallAt(top_ks=(10, 20)),
)


def label_ranks(scores: torch.Tensor, labels: torch.Tensor, max_k: int) -> torch.Tensor:
    """0-based rank of each label in the top ``max_k`` of ``scores`` (N, V);
    ``max_k`` where it is not among them. (N,) int32."""
    top_ids = torch.topk(scores, max_k, dim=-1).indices
    hit = top_ids == labels.long()[:, None]
    rank = hit.to(torch.int32).argmax(dim=-1)
    return torch.where(hit.any(dim=-1), rank, max_k).to(torch.int32)


def compute_batch_metrics(
    scores: torch.Tensor,
    labels: torch.Tensor,
    metrics: Sequence[RankingMetric] = DEFAULT_METRICS,
    weights: Optional[torch.Tensor] = None,
) -> MetricState:
    """Per-batch (weighted sum, weight count) for every metric × cutoff, from
    dense scores (N, V)."""
    max_k = max(k for m in metrics for k in m.top_ks)
    return metrics_from_ranks(label_ranks(scores, labels, max_k), metrics, weights)


def metrics_from_ranks(
    rank: torch.Tensor,
    metrics: Sequence[RankingMetric] = DEFAULT_METRICS,
    weights: Optional[torch.Tensor] = None,
) -> MetricState:
    """Per-batch (weighted sum, weight count) for every metric × cutoff."""
    if weights is None:
        weights = torch.ones_like(rank, dtype=torch.float32)
    weights = weights.float()
    count = weights.sum()
    out = {}
    for m in metrics:
        for k in m.top_ks:
            out[m.key(k)] = ((m.from_rank(rank, k) * weights).sum(), count)
    return out


def init_metric_state(metrics: Sequence[RankingMetric] = DEFAULT_METRICS) -> MetricState:
    state: MetricState = {}
    for m in metrics:
        for k in m.top_ks:
            state[m.key(k)] = (torch.zeros(()), torch.zeros(()))
    return state


def update_metric_state(state: MetricState, batch: MetricState) -> MetricState:
    return {
        name: (state[name][0] + s, state[name][1] + c)
        for name, (s, c) in batch.items()
    }


def finalize_metrics(state: MetricState) -> Dict[str, torch.Tensor]:
    return {
        name: torch.where(c > 0, s / c.clamp_min(1.0), torch.zeros_like(s))
        for name, (s, c) in state.items()
    }
