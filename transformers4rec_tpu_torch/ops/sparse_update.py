"""Which parameters are embedding tables, and the row-wise optimizers for them.

Counterpart of ``transformers4rec_tpu/ops/sparse_update.py``:

- ``label_embedding_params``: the labels that route every embedding table
  (not only the item table) to the table optimizer and everything else to
  the dense one;
- ``LazyAdam``: Adam that advances the moments and the parameter only where
  the gradient is nonzero (a row of a 2-D parameter counts as touched when
  any of its elements is nonzero; a 1-D parameter's elements count on their
  own), with the bias correction of the global count (TF ``LazyAdam``);
- the O(N·E) update of the rows a step touched, N = ids a step: the step
  gathers the table's rows outside autograd, so no dense (V, E) gradient
  exists. ``dedupe_row_grads`` sums the gradients of repeated ids;
  ``sparse_rows_adam_update`` (lazy Adam) and ``sparse_rows_adafactor_update``
  (lazy unfactored Adafactor, its update-RMS clip over the full ``V·E``) move
  those rows and their moments; ``sharded_rows_adam_update`` does it for one
  shard of a row-sharded table, the shard given as a row range.

No function here reads a value back to the host, and every shape is static.
``dedupe_row_grads`` keeps the length N of its input: the slots past the
unique ids carry the id ``V`` and a zero gradient. PyTorch's index ops have
no drop mode, so such a padding slot is sent to row ``V - 1`` with the
value ``-0.0``, and every write is an ``index_add_``: ``x + (-0.0)`` is
``x`` bit for bit, for ``x = -0.0`` too, so a padding slot changes no row.
A moment row is set by two adds, ``-old`` (which leaves exactly ``+0``) and
then ``new``: each real row is written by one slot of each add, exactly,
in its storage dtype. The arithmetic is float32 whatever the moments'
storage (bf16 moments are upcast when gathered and rounded once when
written), with the bias corrections and decays taken in float32 from the
count on the device. ``learning_rate`` is the float of the rate at the
count before the step (the caller's schedule, read on the host).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]


def label_embedding_params(named_parameters: Iterable[Tuple[str, torch.Tensor]],
                           pattern: str = "_table") -> Dict[str, str]:
    """``{name: "table" | "dense"}``. A parameter is a table when its name
    contains ``pattern``. The reference names a table ``<feature>_table``; the
    port keeps its tables in ``EmbeddingFeatures.tables`` (``...tables.<feature>``),
    which the default pattern matches too."""
    def is_table(name: str) -> bool:
        if pattern in name:
            return True
        return pattern == "_table" and ("tables." in name)

    return {name: "table" if is_table(name) else "dense" for name, _ in named_parameters}


@dataclasses.dataclass
class GatheredRows:
    """The item table's rows that a sparse step gathered before the model
    runs, handed to the model in place of its two reads of the table. Row
    layout: ``[lookup rows (n_in) | label rows (only under swap noise) |
    negatives]``. The item column's lookup reads ``rows[:n_in]``; the
    sampled softmax scores against ``rows[pos_map]`` and ``rows[neg_base:]``
    (``neg_ids`` the negatives' ids). ``aug_inputs``, when the step drew the
    swap noise itself, replaces the input module's own draw."""

    rows: torch.Tensor  # (R, E), a leaf that takes the gradient
    n_in: int
    pos_map: torch.Tensor  # (B·S,) long: the row of each position's label
    neg_base: int
    neg_ids: torch.Tensor  # (n,) long
    aug_inputs: Optional[Dict[str, torch.Tensor]] = None

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The lookup rows shaped as ``ids`` (B, S) → (B, S, E)."""
        return self.rows[:self.n_in].reshape(*ids.shape, -1)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device: a tensor built from a host value would be a
    # copy that waits for the device's queue
    return torch.full((), x, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------- lazy adam
class LazyAdam(torch.optim.Optimizer):
    """``lazy_adam``: ``lr`` is a float or a callable of the count before the
    step (counted from 0, as the dense arms read their schedule); the bias
    correction takes the count after it. A parameter without a gradient is
    untouched everywhere, and the count still advances (the reference's
    count is one for the whole tree)."""

    def __init__(self, params, lr: ScalarOrSchedule, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        self.learning_rate = lr
        defaults = dict(lr=float(lr(0)) if callable(lr) else float(lr), betas=betas, eps=eps)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lr_fn = self.learning_rate
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps = group["eps"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                step = state["step"]
                state["step"] = step + 1
                if p.grad is None:
                    continue
                group["lr"] = lr = float(lr_fn(step)) if callable(lr_fn) else float(lr_fn)
                count = torch.full((), float(step + 1), dtype=torch.float32, device=p.device)
                bc1 = 1.0 - _f32(b1, p) ** count
                bc2 = 1.0 - _f32(b2, p) ** count
                g = p.grad
                touched = (g != 0).flatten(1).any(dim=1).view(-1, *([1] * (g.dim() - 1))) \
                    if g.dim() >= 2 else g != 0
                # in place, with two temporaries of the parameter's size and
                # the reference's order of roundings: an untouched row has
                # g == 0, so its moments are scaled by 1 and added 0, and its
                # step is multiplied by 0
                mu, nu = state["mu"], state["nu"]
                t = torch.mul(g, 1.0 - b1)
                mu.mul_(torch.where(touched, b1, 1.0)).add_(t)
                nu.mul_(torch.where(touched, b2, 1.0)).add_(torch.mul(g, 1.0 - b2, out=t).mul_(g))
                den = torch.div(nu, bc2, out=t).sqrt_().add_(eps)
                upd = torch.div(mu, bc1).mul_(-lr).div_(den)
                p.addcmul_(upd, touched.to(upd.dtype))
        return loss


# --------------------------------------------------- true sparse (gather/scatter)
@dataclasses.dataclass
class SparseRowsAdamState:
    count: torch.Tensor  # () int32, on the table's device
    mu: torch.Tensor  # (V, E) in the moments' storage dtype; only touched rows move
    nu: torch.Tensor


@dataclasses.dataclass
class SparseRowsAdafactorState:
    count: torch.Tensor  # () int32
    v: torch.Tensor  # (V, E) unfactored second moment


def sparse_rows_adam_init(table: torch.Tensor,
                          moment_dtype: Optional[torch.dtype] = None) -> SparseRowsAdamState:
    """``moment_dtype`` (``torch.bfloat16``) stores mu and nu narrower; the
    arithmetic stays float32."""
    dt = moment_dtype or torch.float32
    return SparseRowsAdamState(
        count=torch.zeros((), dtype=torch.int32, device=table.device),
        mu=torch.zeros(table.shape, dtype=dt, device=table.device),
        nu=torch.zeros(table.shape, dtype=dt, device=table.device))


def sparse_rows_adafactor_init(table: torch.Tensor, moment_dtype: Optional[torch.dtype] = None
                               ) -> SparseRowsAdafactorState:
    return SparseRowsAdafactorState(
        count=torch.zeros((), dtype=torch.int32, device=table.device),
        v=torch.zeros(table.shape, dtype=moment_dtype or torch.float32, device=table.device))


def dedupe_row_grads(ids: torch.Tensor, row_grads: torch.Tensor,
                     vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum the gradients of repeated ids: ``(uids, summed)`` of the input's
    length N, the unique ids in ascending order first, then padding slots of
    ``uid == vocab_size`` and a zero gradient. A stable sort, a mark at each
    segment's first element, ``cumsum − 1`` and a segment sum by
    ``index_add_``; nothing is read back (no ``torch.unique``)."""
    ids = ids.reshape(-1).long()
    row_grads = row_grads.reshape(ids.shape[0], -1)
    n = ids.shape[0]
    sid, order = torch.sort(ids, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1  # (N,) in [0, n_unique)
    summed = torch.zeros_like(row_grads).index_add_(0, seg, row_grads[order])
    # each segment's id (a max over equal values); empty segments keep the sentinel
    uids = torch.full((n,), vocab_size, dtype=ids.dtype, device=ids.device).scatter_reduce_(
        0, seg, sid, reduce="amax", include_self=False)
    return uids, summed


def _slots(uids: torch.Tensor, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row of each slot, kept): a slot whose id lies outside ``[0, rows)``
    is a padding slot, sent to row ``rows - 1`` and not kept."""
    keep = (uids >= 0) & (uids < rows)
    return torch.where(keep, uids, rows - 1), keep


def _gather(t: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """float32 rows of ``t``; a padding slot reads zeros (the reference's
    ``mode="fill"``)."""
    rows = t.index_select(0, idx).float()
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))


def _add_rows_(t: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
               delta: torch.Tensor) -> None:
    """``t[idx] += delta`` for the kept slots; a padding slot adds ``-0.0``."""
    delta = delta.to(t.dtype)
    t.index_add_(0, idx, torch.where(keep[:, None], delta, torch.full_like(delta, -0.0)))


def _set_rows_(t: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
               new: torch.Tensor) -> None:
    """``t[idx] = new`` (rounded once to ``t``'s dtype) for the kept slots:
    ``-old`` leaves each such row at exactly +0, then ``new`` is added."""
    _add_rows_(t, idx, keep, -t.index_select(0, idx))
    _add_rows_(t, idx, keep, new.to(t.dtype))


@torch.no_grad()
def sparse_rows_adam_update(table: torch.Tensor, state: SparseRowsAdamState, ids: torch.Tensor,
                            row_grads: torch.Tensor, learning_rate: float,
                            b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                            deduped: bool = False):
    """Lazy Adam on the rows named by ``ids``, in place: ``(table, state)``.
    ``row_grads`` (N, E) is the gradient with respect to ``table[ids]``; with
    ``deduped`` the ids are already ``dedupe_row_grads``'s (unique, padding
    slots at ``V``)."""
    V = table.shape[0]
    lr = float(learning_rate)
    count = (state.count + 1).float()
    bc1 = 1.0 - _f32(b1, table) ** count
    bc2 = 1.0 - _f32(b2, table) ** count
    if not deduped:
        ids, row_grads = dedupe_row_grads(ids, row_grads, V)
    idx, keep = _slots(ids, V)
    g = row_grads.float()
    mu = b1 * _gather(state.mu, idx, keep) + (1 - b1) * g
    nu = b2 * _gather(state.nu, idx, keep) + (1 - b2) * g * g
    step = lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    _add_rows_(table, idx, keep, -step)
    _set_rows_(state.mu, idx, keep, mu)
    _set_rows_(state.nu, idx, keep, nu)
    state.count = state.count + 1
    return table, state


@torch.no_grad()
def sparse_rows_adafactor_update(table: torch.Tensor, state: SparseRowsAdafactorState,
                                 ids: torch.Tensor, row_grads: torch.Tensor,
                                 learning_rate: float, decay_rate: float = 0.8,
                                 decay_offset: int = 0,
                                 clipping_threshold: Optional[float] = 1.0, eps: float = 1e-30,
                                 deduped: bool = False):
    """Lazy unfactored Adafactor on the rows named by ``ids``, in place:
    the dense op's arithmetic per touched row (decay ``1 − (t + 1)^−0.8`` at
    the count t before the step, eps inside, rsqrt of the unrounded moment)
    and its update-RMS clip over the full ``V·E`` (untouched rows add 0 to
    its numerator). The count advances after the step."""
    V, E = table.shape
    count = state.count
    lr = float(learning_rate)
    decay = 1.0 - (count - decay_offset + 1).float() ** (-decay_rate)
    if not deduped:
        ids, row_grads = dedupe_row_grads(ids, row_grads, V)
    idx, keep = _slots(ids, V)
    g = row_grads.float()
    new_v = decay * _gather(state.v, idx, keep) + (1.0 - decay) * (g * g + eps)
    inv = torch.rsqrt(new_v)
    if clipping_threshold is not None:
        # padding slots carry g == 0 and add nothing to the numerator
        rms = torch.sqrt(torch.sum((g * inv) ** 2) / (V * E))
        scale = 1.0 / torch.clamp_min(rms / clipping_threshold, 1.0)
    else:
        scale = 1.0
    _add_rows_(table, idx, keep, g * ((-lr * scale) * inv))
    _set_rows_(state.v, idx, keep, new_v)
    state.count = count + 1
    return table, state


@torch.no_grad()
def sharded_rows_adam_update(table: torch.Tensor, state: SparseRowsAdamState, ids: torch.Tensor,
                             row_grads: torch.Tensor, learning_rate: float,
                             lo: int, rows_per_shard: int, b1: float = 0.9, b2: float = 0.999,
                             eps: float = 1e-8):
    """``sparse_rows_adam_update`` on one shard of a row-sharded table: this
    shard holds rows ``[lo, lo + rows_per_shard)`` of the whole table as
    ``table`` (rows_per_shard, E). Every shard dedupes the same ids (all of
    them), rebases them into its range and drops those outside it; no id
    lives on two shards, so no collective is needed."""
    if table.shape[0] != rows_per_shard:
        raise ValueError(f"the shard holds {table.shape[0]} rows, not {rows_per_shard}")
    uids, g = dedupe_row_grads(ids, row_grads, lo + rows_per_shard)
    rel = uids - lo
    rel = torch.where((rel >= 0) & (rel < rows_per_shard), rel,
                      torch.full_like(rel, rows_per_shard))
    return sparse_rows_adam_update(table, state, rel, g, learning_rate, b1=b1, b2=b2, eps=eps,
                                   deduped=True)
