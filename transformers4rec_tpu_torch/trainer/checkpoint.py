"""Checkpoint files, the sharded format and asynchronous writes.

Counterpart of ``transformers4rec_tpu/trainer/checkpoint.py``. The
trainer writes one of two formats (``T4RecTrainingArguments.checkpoint_format``):

- ``"torch"`` (the JAX package's ``"msgpack"``): the row shards are gathered
  over the model group and rank 0 writes one ``trainer.pt``;
- ``"sharded"`` (the JAX package's ``"orbax"``): no gather. Rank 0 writes
  ``replicated-of-M.pt``, everything but the row-sharded tensors, which
  stand there as ``RowShard`` references; each rank of data row 0 writes
  the rows it holds of every row-sharded tensor (a table, its optimizer
  state, the sparse rows' state, pending gradients) to
  ``rows-{i}-of-M.pt``, i its model index. Loading reads the shard files
  memory-mapped (``torch.load(mmap=True)``) and copies out only the rows
  the loading rank holds, so a checkpoint restores onto any (data, model)
  layout and no rank holds a whole row-sharded table on save or on load
  unless it holds the whole table in training.

Every file is written under another name and renamed into place, so a
file that exists is whole; a checkpoint is complete when all its files
exist (``checkpoint_complete``). With ``save_async`` the trainer takes its
host snapshot on the caller's thread and the files are written on a thread;
``register_pending`` and ``wait_all_pending`` keep the process-wide list of
writes in flight, which a save, a rotation, a load and the end of
``train()`` wait for.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Callable, Dict, List, Optional

import torch

CHECKPOINT_FILE = "trainer.pt"
_REPLICATED = re.compile(r"replicated-of-(\d+)\.pt$")

# process-wide writes in flight: a reader waits for every pending save, not
# only those of its own trainer
_PENDING: List[Callable[[], None]] = []
_PENDING_LOCK = threading.Lock()


def register_pending(wait: Callable[[], None]) -> None:
    with _PENDING_LOCK:
        _PENDING.append(wait)


def wait_all_pending() -> None:
    """Block until every asynchronous checkpoint write started in this
    process is on disk."""
    with _PENDING_LOCK:
        waits, _PENDING[:] = list(_PENDING), []
    for wait in waits:
        wait()


def replicated_file(shards: int) -> str:
    return f"replicated-of-{shards}.pt"


def rows_file(index: int, shards: int) -> str:
    return f"rows-{index}-of-{shards}.pt"


def checkpoint_complete(path: str) -> bool:
    """A ``"torch"`` checkpoint with its file, or a ``"sharded"`` one with
    its replicated file and every shard file."""
    if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):
        return True
    shards = sharded_shards(path)
    return shards is not None and all(
        os.path.isfile(os.path.join(path, rows_file(i, shards))) for i in range(shards))


def sharded_shards(path: str) -> Optional[int]:
    """The shard count of the sharded checkpoint at ``path`` (0 when it has
    no row-sharded tensor), or None when its replicated file is absent."""
    if not os.path.isdir(path):
        return None
    for name in os.listdir(path):
        m = _REPLICATED.match(name)
        if m:
            return int(m.group(1))
    return None


def snapshot(tree):
    """``tree`` (dicts, lists, tuples) with every tensor copied to host
    memory: what a write needs, taken before the live state moves on."""
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def write_files(path: str, files: Dict[str, object], blocking: bool) -> None:
    """``torch.save`` each document of ``files`` (name → host snapshot)
    under ``path``, each renamed into place when whole; on a registered
    thread unless ``blocking``."""
    def write():
        for name, doc in files.items():
            tmp = os.path.join(path, name + ".tmp")
            torch.save(doc, tmp)
            os.replace(tmp, os.path.join(path, name))

    if not files:
        return
    os.makedirs(path, exist_ok=True)
    if blocking:
        write()
        return
    thread = threading.Thread(target=write, name="t4r-checkpoint", daemon=True)
    thread.start()
    register_pending(thread.join)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A row-sharded tensor in a sharded checkpoint's replicated file: its
    ``rows`` rows are split evenly over ``shards`` shard files, which hold
    their part under ``key``."""

    key: int
    rows: int
    shards: int


class RowShards:
    """Collects one rank's row shards while the trainer builds a sharded
    checkpoint: each call files a local shard and returns its reference."""

    def __init__(self, shards: int):
        self.shards = shards
        self.local: Dict[int, torch.Tensor] = {}

    def __call__(self, t: torch.Tensor) -> RowShard:
        key = len(self.local)
        self.local[key] = t
        return RowShard(key, t.shape[0] * self.shards, self.shards)


class ShardReader:
    """Rows of a sharded checkpoint's row-sharded tensors, copied out of
    the memory-mapped shard files that hold them."""

    def __init__(self, path: str):
        self.path = path
        self._files: Dict[int, dict] = {}

    def _file(self, index: int, shards: int) -> dict:
        if index not in self._files:
            self._files[index] = torch.load(os.path.join(self.path, rows_file(index, shards)),
                                            map_location="cpu", mmap=True, weights_only=True)
        return self._files[index]

    def rows(self, ref: RowShard, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` of the whole tensor ``ref`` stands for."""
        per = ref.rows // ref.shards
        parts = []
        for i in range(lo // per, (hi - 1) // per + 1):
            t = self._file(i, ref.shards)[ref.key]
            parts.append(t[max(lo - i * per, 0):min(hi - i * per, per)])
        return torch.cat(parts) if len(parts) > 1 else parts[0].clone()
