"""In-memory batch loaders.

Counterpart of the in-memory part of ``transformers4rec_tpu/data/loader.py``:
a loader over a dict of numpy columns (what ``synthetic_data`` returns) that
yields fixed-shape batches, shuffled by ``seed + epoch`` so an epoch's order
can be replayed, and ``SyntheticDataLoader.from_schema``. For the same seed
the batches are those of the JAX package's loader. The Parquet loaders are
not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..schema import Schema
from .synthetic import synthetic_data

NDArrayDict = Dict[str, np.ndarray]


class InMemoryDataLoader:
    """Yields ``{name: (batch_size, ...)}`` numpy batches from columns held
    in memory. Every batch is full-size: ``drop_last`` drops the ragged tail;
    otherwise the last batch is filled with all-zero rows, whose empty target
    masks carry no loss or metric weight, so each real row counts once."""

    def __init__(self, data: NDArrayDict, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.data = {k: np.asarray(v) for k, v in data.items()}
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_rows = len(next(iter(self.data.values())))
        self._epoch = 0
        self._skip_batches = 0

    def __len__(self) -> int:
        if self.drop_last:
            return max(1, self.num_rows // self.batch_size)
        return -(-self.num_rows // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(self.num_rows)
        else:
            order = np.arange(self.num_rows)
        total = len(self) * self.batch_size
        if total > self.num_rows:  # fill slots are marked -1
            order = np.concatenate([order, np.full(total - self.num_rows, -1, order.dtype)])
        return order[:total]

    def set_state(self, epoch: int, batches_consumed: int) -> None:
        """Position the loader for a mid-epoch resume: the next iteration
        replays epoch ``epoch``'s order and skips its first
        ``batches_consumed`` batches."""
        self._epoch = epoch
        self._skip_batches = batches_consumed

    def __iter__(self) -> Iterator[NDArrayDict]:
        order = self._epoch_order()
        self._epoch += 1
        skip = self._skip_batches * self.batch_size
        self._skip_batches = 0
        for start in range(skip, len(order), self.batch_size):
            sel = order[start:start + self.batch_size]
            fill = sel < 0
            if fill.any():
                out = {k: v[np.where(fill, 0, sel)].copy() for k, v in self.data.items()}
                for v in out.values():
                    v[fill] = 0
                yield out
            else:
                yield {k: v[sel] for k, v in self.data.items()}


class SyntheticDataLoader(InMemoryDataLoader):
    """Loader over schema-synthesized data: needs no files."""

    @classmethod
    def from_schema(cls, schema: Schema, paths_or_dataset=None, batch_size: int = 16,
                    max_sequence_length: Optional[int] = None, num_rows: int = 256,
                    shuffle: bool = True, drop_last: bool = True,
                    seed: int = 0) -> "SyntheticDataLoader":
        max_len = max_sequence_length or schema.sequence_length(default=20)
        data = synthetic_data(schema, num_rows=num_rows, max_session_length=max_len, seed=seed)
        return cls(data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed)
