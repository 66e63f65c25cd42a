"""Vocab-parallel item table: lookup, softmax cross-entropy, ranks and top-k
with the table's rows split over a group of processes.

Counterpart of ``transformers4rec_tpu/parallel/sharded_embedding.py``. The
reference's ``'model'`` mesh axis is a ``torch.distributed`` process group
here: the rank of index r holds rows ``[r·V_l, (r+1)·V_l)`` of the (V, E)
table, and x, labels and weights are the same on every rank of the group.
Every function runs the single-device kernels of ``ops/vocab.py`` on the
local rows with the shard's own vocab bound (K1, K2 and K4) and merges O(N)
numbers per shard; the table itself never travels:

    lse      online-logsumexp merge: max and sum of exp over the shards
    ll       sum (only the owning shard's column matches the label)
    zsum     sum (label smoothing; ε/V is that of the *global* vocab)
    rank     sum of the local counts of strictly greater logits
    dx       sum over the shards; dW is the local rows' own
    top-k    k candidates per shard, ids made global, one ``torch.topk``

Each function is a local part (one shard's rows in, O(N) partials out) and
one merge. ``group`` selects where the shards live: a process group (``W``
is this rank's shard; the partials are gathered over the group), or ``None``
(``W`` is the sequence of all shards, held by this one process; the
partials are stacked). Both take the same merge.

Labels outside a shard's valid rows become -1 there: a raw offset could
land on one of the shard's padding rows and pick up its masked logit.

A shard may be stored as bf16 (a bf16-stored table): the kernels take it as
it is, its gradient comes back bf16, and the lookup's sum over the group
adds one shard's bf16 rows to the others' zeros, exactly.

The reference's ``'data'`` mesh axis (the sums of the loss's numerator and
denominator over data-parallel replicas) is data parallelism and is not
part of this module: every rank of the group sees the whole batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..ops.vocab import ce_bwd, ce_fwd, fused_topk, rank_counts

Shards = Union[torch.Tensor, Sequence[torch.Tensor]]


def shard_table(table: torch.Tensor, index: int, world: int) -> torch.Tensor:
    """Rows ``[index·V_l, (index+1)·V_l)`` of ``table``, ``V_l = rows / world``
    (a view). The rows must divide by ``world``."""
    V = table.shape[0]
    if V % world:
        raise ValueError(f"vocab {V} must divide the group's size ({world})")
    V_l = V // world
    return table[index * V_l:(index + 1) * V_l]


def _local_shards(W: Shards, group) -> Tuple[List[Tuple[int, torch.Tensor]], int]:
    """``([(shard index, shard)], number of shards)`` held by this process."""
    if group is None:
        if torch.is_tensor(W):
            raise ValueError("without a process group, W is the sequence of all shards")
        shards = list(W)
        if len({tuple(w.shape) for w in shards}) != 1:
            raise ValueError("the shards of a table must have equal shapes, got "
                             f"{[tuple(w.shape) for w in shards]}")
        return list(enumerate(shards)), len(shards)
    return [(dist.get_rank(group), W)], dist.get_world_size(group)


def _gather(parts: List[torch.Tensor], group) -> torch.Tensor:
    """The partials of every shard, stacked in shard order: (shards, ...)."""
    if group is None:
        return torch.stack(parts)
    out = [torch.empty_like(parts[0]) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, parts[0].contiguous(), group=group)
    return torch.stack(out)


def _sum(parts: List[torch.Tensor], group) -> torch.Tensor:
    """The sum of the partials of every shard."""
    if group is None:
        return torch.stack(parts).sum(0)
    total = parts[0].clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total


def _local_bounds(V_l: int, vocab_size: Optional[int], index: int, world: int) -> Tuple[int, int]:
    """``(first global row, valid rows)`` of shard ``index``: the true vocab
    may end inside the shard, or before it."""
    v0 = index * V_l
    total = V_l * world if vocab_size is None else int(vocab_size)
    return v0, min(max(total - v0, 0), V_l)


def _local_labels(labels: torch.Tensor, v0: int, vsz: int) -> torch.Tensor:
    local = labels.to(torch.int32) - v0
    return torch.where((local >= 0) & (local < vsz), local, -1).to(torch.int32).contiguous()


def _merge_lse(lse_parts: torch.Tensor, ll_parts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shards, N) per-shard logsumexps and label logits → the global ones."""
    m = lse_parts.max(0).values
    lse_g = m + torch.log(torch.exp(lse_parts - m).sum(0))
    return lse_g, ll_parts.sum(0)


def _merged_nll(parts: torch.Tensor, eps: float, v_total: int):
    """Per-row smoothed NLL from the (shards, 3, N) accumulators (lse, ll,
    zsum): ``lse − (1−ε)·ll − (ε/V)·zsum`` with V the global vocab. One
    definition for the training loss and the evaluation, so the two cannot
    drift. Returns ``(nll, lse, ll)``."""
    lse_g, ll_g = _merge_lse(parts[:, 0], parts[:, 1])
    if eps:
        return lse_g - (1.0 - eps) * ll_g - (eps / v_total) * parts[:, 2].sum(0), lse_g, ll_g
    return lse_g - ll_g, lse_g, ll_g


def _ce_fwd_local(x, W_l, labels, v0: int, vsz: int, smooth: bool) -> torch.Tensor:
    """One shard's (3, N) accumulators: lse, label logit, sum of logits."""
    lse, ll, zs = ce_fwd(x, W_l, _local_labels(labels, v0, vsz), vsz, smooth)
    return torch.stack([lse, ll, zs if smooth else torch.zeros_like(lse)])


def _forward_parts(x, W: Shards, labels, group, vocab_size, smooth: bool):
    """``(merged-ready partials (shards, 3, N), global vocab)``."""
    shards, world = _local_shards(W, group)
    V_l = shards[0][1].shape[0]
    parts = [_ce_fwd_local(x, W_l, labels, *_local_bounds(V_l, vocab_size, i, world), smooth)
             for i, W_l in shards]
    return _gather(parts, group), (V_l * world if vocab_size is None else int(vocab_size))


class _ShardedSoftmaxCE(torch.autograd.Function):
    """K1 per shard, one merge; backward K2 per shard with the global lse,
    dx summed over the shards, dW the local rows' own."""

    @staticmethod
    def forward(ctx, x, labels, weights, group, vocab_size, eps, *shards):
        W = shards[0] if group is not None else shards
        xf = x.float().contiguous()
        parts, v_total = _forward_parts(xf, W, labels, group, vocab_size, eps > 0)
        nll, lse_g, _ = _merged_nll(parts, eps, v_total)
        w = weights.float()
        wsum = w.sum().clamp_min(1.0)
        ctx.save_for_backward(xf, labels, w, wsum, lse_g, *shards)
        ctx.group, ctx.vocab_size, ctx.eps, ctx.v_total = group, vocab_size, eps, v_total
        ctx.x_dtype = x.dtype
        return (nll * w).sum() / wsum

    @staticmethod
    def backward(ctx, g):
        xf, labels, w, wsum, lse_g, *tensors = ctx.saved_tensors
        group, eps = ctx.group, ctx.eps
        shards, world = _local_shards(tensors[0] if group is not None else tensors, group)
        coef = (g * w / wsum).contiguous()
        lse_g = lse_g.contiguous()
        V_l = shards[0][1].shape[0]
        dxs, dWs = [], []
        for i, W_l in shards:
            v0, vsz = _local_bounds(V_l, ctx.vocab_size, i, world)
            dx_p, dW_l = ce_bwd(xf, W_l, _local_labels(labels, v0, vsz), lse_g, coef, vsz,
                                eps, eps / ctx.v_total if eps else None)
            dxs.append(dx_p)
            dWs.append(dW_l.to(W_l.dtype))
        dx = _sum(dxs, group)
        return (dx.to(ctx.x_dtype), None, None, None, None, None, *dWs)


def _as_shard_args(W: Shards, group) -> tuple:
    return (W,) if group is not None else tuple(W)


def sharded_softmax_ce(
    x: torch.Tensor,
    W: Shards,
    labels: torch.Tensor,
    weights: torch.Tensor,
    group,
    vocab_size: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Differentiable weighted-mean CE of ``x @ W.T`` with the rows of W
    split over ``group``. The same value and gradients as
    ``ops.vocab.fused_softmax_ce`` on the whole table, label smoothing
    included; the gradient of W is that of the local rows. ``vocab_size`` is
    the global true vocab. ``weights`` is a validity mask and gets no
    gradient."""
    return _ShardedSoftmaxCE.apply(x, labels, weights.detach(), group, vocab_size,
                                   float(label_smoothing), *_as_shard_args(W, group))


@torch.no_grad()
def sharded_ce_and_rank(
    x: torch.Tensor,
    W: Shards,
    labels: torch.Tensor,
    weights: torch.Tensor,
    group,
    vocab_size: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocab-parallel ``(loss, ranks)`` for evaluation, the counterpart of
    ``ops.vocab.fused_ce_and_rank`` (not differentiable). K1 per shard gives
    the merged label logit, K4 per shard counts the logits above it on the
    shard's valid rows, and the counts add up to the 0-based rank over the
    global vocab. The label's own column is left out on its owning shard."""
    eps = float(label_smoothing)
    xf = x.float().contiguous()
    parts, v_total = _forward_parts(xf, W, labels, group, vocab_size, eps > 0)
    nll, _, ll_g = _merged_nll(parts, eps, v_total)
    shards, world = _local_shards(W, group)
    V_l = shards[0][1].shape[0]
    ll_g = ll_g.contiguous()
    counts = []
    for i, W_l in shards:
        v0, vsz = _local_bounds(V_l, vocab_size, i, world)
        counts.append(rank_counts(xf, W_l, ll_g, _local_labels(labels, v0, vsz), vsz))
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0), _sum(counts, group)


@torch.no_grad()
def sharded_topk(
    x: torch.Tensor,
    W: Shards,
    k: int,
    group,
    vocab_size: Optional[int] = None,
    chunk: int = 32768,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocab-parallel top-k of ``x @ W.T``: every shard streams a local top-k
    over its valid rows (``ops.vocab.fused_topk``) and makes its ids global,
    the k candidates per shard are gathered, and one ``torch.topk`` merges
    them: O(N·k·shards) numbers travel. Equal to ``fused_topk`` on the whole
    table: the candidates always hold the global top-k. ``compute_dtype``
    defaults to bf16. Returns ``(scores (N, k), ids (N, k))``."""
    dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
    shards, world = _local_shards(W, group)
    V_l = shards[0][1].shape[0]
    scores, ids = [], []
    for i, W_l in shards:
        v0, vsz = _local_bounds(V_l, vocab_size, i, world)
        s, idx = fused_topk(x, W_l, k, chunk=chunk, vocab_size=vsz, compute_dtype=dtype)
        scores.append(s)
        ids.append(idx + v0)
    N = x.shape[0]
    s_all = _gather(scores, group).permute(1, 0, 2).reshape(N, -1)  # (N, shards·k)
    i_all = _gather(ids, group).permute(1, 0, 2).reshape(N, -1)
    best, pos = torch.topk(s_all, k, dim=-1)
    return best, torch.gather(i_all, 1, pos)


class _ShardedLookup(torch.autograd.Function):
    """Forward: the masked gather from the local rows, summed over the
    shards (each id hits exactly one). Backward: the masked scatter into the
    local rows only."""

    @staticmethod
    def forward(ctx, ids, group, *shards):
        local, world = _local_shards(shards[0] if group is not None else shards, group)
        V_l = local[0][1].shape[0]
        parts, saved = [], []
        for i, table in local:
            rel = ids.long() - i * V_l
            in_range = (rel >= 0) & (rel < V_l)
            safe = rel.clamp(0, V_l - 1)
            parts.append(table[safe] * in_range[..., None].to(table.dtype))
            saved += [safe, in_range]
        ctx.save_for_backward(*saved)
        ctx.shapes = [t.shape for _, t in local]
        return _sum(parts, group)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        grads = []
        for n, shape in enumerate(ctx.shapes):
            safe, in_range = saved[2 * n], saved[2 * n + 1]
            masked = grad * in_range[..., None].to(grad.dtype)
            g = torch.zeros(shape, dtype=grad.dtype, device=grad.device)
            g.index_add_(0, safe.reshape(-1), masked.reshape(-1, shape[-1]))
            grads.append(g)
        return (None, None, *grads)


def sharded_embedding_lookup(table: Shards, ids: torch.Tensor, group) -> torch.Tensor:
    """Rows of a row-sharded ``table`` for ``ids`` (any shape, the same on
    every rank): embeddings laid out like ``ids`` plus a trailing dimension,
    the same on every rank. One sum of ids-shape × dim activations over the
    group; the table is never gathered. The gradient of ``table`` is that
    of the local rows."""
    return _ShardedLookup.apply(ids, group, *_as_shard_args(table, group))
