"""The ('data', 'model') layout of ``torch.distributed`` ranks: the
distribution layer.

Counterpart of ``transformers4rec_tpu/parallel/mesh.py``. The JAX package
lays its devices out as one ``('data', 'model')`` mesh and lets XLA insert
the collectives; here every rank is a process with its own device, and the
collectives are written out:

- ``make_mesh(data, model)`` arranges the world's ranks row-major as a
  (data, model) grid, as ``np.reshape`` orders the JAX devices. The ranks of
  one data row form a *model group* (they hold the rows of a row-sharded
  table between them and see the same batch); the ranks of one model column
  form a *data group* (replicas of the same parameters, each on its own
  stripe of the batch).
- batches are split over 'data': each data row's loader loads one stripe
  (``process_data_stripe``, the loaders' ``global_rank``/``global_size``),
  every rank of that row the same rows, and copies it to its own device.
- parameters are replicated, and a ``*_table`` of at least
  ``MIN_ROWS_TO_SHARD`` rows that divide the model size is row-sharded over
  'model' (``shards_rows``): each rank of a model group keeps ``V / M`` rows.
- the data axis: every gradient is summed over the data group once per
  update (``all_reduce_grads_``), and every task's loss is the global
  weighted mean (``data_parallel_loss``): numerators and denominators summed
  over the data group before the division, as the JAX package's
  ``psum``s over ``'data'`` give.

Collectives run on the tensors' own device: NCCL for a card a rank, Gloo
where ranks share a card or run on the CPU. Every collective that fails
raises; no path gathers a row-sharded table except a checkpoint's save.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# row threshold below which tables stay replicated; the trainer's
# vocab-parallel engagement keys off the same constant, so the sharded CE
# and the table's sharding can never disagree
MIN_ROWS_TO_SHARD = 16384


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, model) grid of ranks, and this rank's place in it.

    ``ranks[i, j]`` is the global rank at data index i, model index j.
    ``model_group`` holds this rank's data row (``None`` when ``model == 1``),
    ``data_group`` its model column (``None`` when ``data == 1``): a group of
    one rank is never made, its collectives being identities."""

    ranks: np.ndarray
    rank: int
    model_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.ranks.shape[0], "model": self.ranks.shape[1]}

    @property
    def data(self) -> int:
        return self.ranks.shape[0]

    @property
    def model(self) -> int:
        return self.ranks.shape[1]

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 0])

    @property
    def model_index(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 1])

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}, "
                f"data_index={self.data_index}, model_index={self.model_index})")


def world() -> Tuple[int, int]:
    """``(rank, world size)``: ``(0, 1)`` without an initialised world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A ('data', 'model') layout of every rank of the initialised world
    (one rank without a world). ``data`` defaults to ``world // model``;
    ``data * model`` must be the world's size. Every rank must call this
    with the same arguments, in the same order as its other group-making
    calls: each group is made by all ranks (``dist.new_group``)."""
    rank, n = world()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    grid = np.arange(n).reshape(data, model)
    model_group = data_group = None
    if model > 1:
        for row in grid:
            g = dist.new_group(row.tolist())
            if rank in row:
                model_group = g
    if data > 1:
        for col in grid.T:
            g = dist.new_group(col.tolist())
            if rank in col:
                data_group = g
    return Mesh(ranks=grid, rank=rank, model_group=model_group, data_group=data_group)


def process_data_stripe(mesh: Mesh) -> Tuple[int, int]:
    """``(stripe, stripes)`` of this rank's loader: its data index of the
    mesh's data size. Every rank of a data row loads the same stripe, so the
    model group's collectives see the same batch on each of its ranks."""
    return mesh.data_index, mesh.data


def shards_rows(rows: int, model_size: int, min_rows: int = MIN_ROWS_TO_SHARD) -> bool:
    """The row-sharding rule of a ``*_table`` (JAX ``param_shardings``): a
    model axis above 1, at least ``min_rows`` rows, and rows that divide the
    model size. Tables are padded to a multiple of 8 rows when they are made
    so that real vocabularies meet the last condition."""
    return model_size > 1 and rows >= min_rows and rows % model_size == 0


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along the first axis,
    in rank order (``t`` itself without a group)."""
    if group is None:
        return t
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out)


def barrier(mesh: Mesh, device) -> None:
    """Wait for every rank of the layout (the world's, when it has more
    than one): a sum of one element on ``device``, which every backend
    takes."""
    if mesh.size > 1:
        dist.all_reduce(torch.zeros(1, device=device))


def all_reduce_grads_(params: Sequence[torch.nn.Parameter], group) -> None:
    """Sum the gradients of ``params`` (those that have one) over ``group``
    in one collective: a float32 buffer of all of them, written back in
    each gradient's own type."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def broadcast_replicas_(module: torch.nn.Module, mesh: Mesh,
                        shards: Sequence[torch.Tensor] = ()) -> None:
    """Start every replica from the same weights, as DDP does when it is
    made: each replicated parameter and buffer from rank 0, each row shard
    (``shards``) from the rank of data index 0 that holds the same rows."""
    if mesh.size == 1:
        return
    sharded = {id(t) for t in shards}
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if id(t) not in sharded:
                dist.broadcast(t.data, src=int(mesh.ranks[0, 0]))
            elif mesh.data_group is not None:
                dist.broadcast(t.data, src=int(mesh.ranks[0, mesh.model_index]),
                               group=mesh.data_group)


def data_parallel_loss(task_coefficients: Dict[str, float], outs: Dict[str, object],
                       group) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(objective, value)`` of one micro-step under data parallelism.

    Each task's loss is a weighted mean over this rank's rows,
    ``num / max(w, 1)``. Its global form is ``Σ num / max(Σ w, 1)`` over the
    data group: the numerators and the weights (``TaskOutput.loss_weight``;
    one per rank where a task has none) are summed over the group in one
    collective before the division. The objective is this rank's share of
    it, ``loss · max(w, 1) / max(Σ w, 1)``, whose gradients summed over the
    group (``all_reduce_grads_``) are the global loss's; the value is the
    global loss itself, the same on every rank. ``task_coefficients`` weighs
    the tasks as ``Model.forward`` combines them."""
    names = list(outs)
    losses = [outs[n].loss for n in names]
    dev = losses[0].device
    w = torch.stack([torch.ones((), device=dev) if outs[n].loss_weight is None
                     else outs[n].loss_weight.detach().float() for n in names])
    local = w.clamp_min(1.0)
    num = torch.stack([l.detach().float() for l in losses]) * local
    buf = all_reduce_(torch.cat([w, num]), group)
    total_w, total_num = buf[:len(names)].clamp_min(1.0), buf[len(names):]
    coef = torch.tensor([task_coefficients[n] for n in names], device=dev)
    objective = sum(c * l * s for c, l, s in zip(coef, losses, local / total_w))
    return objective, (coef * total_num / total_w).sum()


def take_shard(t: torch.Tensor, index: int, shards: int) -> torch.Tensor:
    """Rows ``[index·V/shards, (index+1)·V/shards)`` of ``t``, a copy."""
    rows = t.shape[0] // shards
    if rows * shards != t.shape[0]:
        raise ValueError(f"{t.shape[0]} rows do not split into {shards} shards")
    return t[index * rows:(index + 1) * rows].clone()


def interleave_stripes(parts: List[torch.Tensor], num_rows: int) -> torch.Tensor:
    """The rows of ``parts`` (one per data stripe, stripe i holding rows
    ``i, i + d, i + 2d, ...`` of the dataset followed by fill rows) in the
    dataset's order, cut to ``num_rows``."""
    stacked = torch.stack(parts, dim=1)  # (rows a stripe, stripes, ...)
    return stacked.reshape(-1, *stacked.shape[2:])[:num_rows]
