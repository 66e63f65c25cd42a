"""Host-side session loaders: Parquet files or numpy columns → fixed-shape
numpy batches.

Counterpart of ``transformers4rec_tpu/data/loader.py``, in numpy and
pyarrow on the host; the trainer copies each batch to the card. For the same
files, arguments and seed the batches are those of the JAX package's
loaders, value for value:

- ``dataloader_registry`` finds a loader by name: ``"parquet"`` (and the
  reference's ``"merlin"``), ``"parquet_streaming"`` and ``"synthetic"``;
- ``ParquetDataLoader`` decodes every file up front (list columns padded by
  ``pad_ragged``) and yields shuffled batches, ``default_rng(seed + epoch)``
  giving each epoch's order; ``InMemoryDataLoader`` is the same loader over
  numpy columns already in memory;
- ``StreamingParquetDataLoader`` reads row groups on demand through a
  bounded shuffle buffer;
- every batch has the same shape: the tail is zero-filled (fill rows carry
  no loss or metric weight, so each real row counts once) unless
  ``drop_last`` drops it; ``global_rank``/``global_size`` stripe rows (or
  row groups) across processes, with ``__len__`` from the global count;
- ``set_state(epoch, batches_consumed)`` positions a loader for a
  mid-epoch resume;
- ``prefetch > 0`` assembles batches on a background thread, which stops
  when the consumer abandons the iterator.

- ``pack=True`` packs sessions several to a row (``data/packing.py``): the
  batches gain ``segment_ids``. ``ParquetDataLoader`` packs every file's
  sessions at once, before striping; ``StreamingParquetDataLoader`` packs
  each shuffle buffer on its own, estimates ``__len__`` from the first
  buffer's sessions per row until one epoch has run, and refuses
  ``global_size > 1`` (its processes would yield different batch counts).

Ragged columns pad through the C++ kernel (``native.pad_ragged``), and a
batch of at least ``NATIVE_GATHER_MIN_BYTES`` gathers its rows through
``native.gather_rows`` (numpy below that, as in the JAX loader); both give
numpy's bits.
"""

from __future__ import annotations

import pathlib
import queue
import threading
import warnings
from typing import Dict, Iterator, List, Optional

import numpy as np

from .. import native
from ..schema import Schema
from ..utils.registry import Registry
from .packing import pack_sessions
from .padding import pad_ragged
from .synthetic import synthetic_data

NDArrayDict = Dict[str, np.ndarray]

dataloader_registry: Registry = Registry("dataloader")

PREFETCH_THREAD_NAME = "t4r-prefetch"
# a batch's bytes from which its row gathers take the native kernel: below,
# numpy's fancy indexing is faster than the kernel's thread fan-out (the JAX
# loader's rule)
NATIVE_GATHER_MIN_BYTES = 4 << 20


def native_gathers(columns: NDArrayDict, batch_size: int) -> bool:
    """Whether a batch of ``batch_size`` rows of ``columns`` is gathered by
    ``native.gather_rows`` (at ``NATIVE_GATHER_MIN_BYTES`` and above)."""
    row_bytes = sum(v.dtype.itemsize * int(np.prod(v.shape[1:], dtype=np.int64))
                    for v in columns.values())
    return batch_size * row_bytes >= NATIVE_GATHER_MIN_BYTES


class T4RecDataLoader:
    """Abstract loader: an iterable of fixed-shape numpy batch dicts."""

    @classmethod
    def from_schema(cls, schema: Schema, paths_or_dataset, batch_size: int, **kwargs):
        raise NotImplementedError

    @classmethod
    def parse(cls, name: str):
        return dataloader_registry.parse(name)

    def __iter__(self) -> Iterator[NDArrayDict]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


def _resolve_paths(paths_or_dataset) -> List[str]:
    """A file, a directory of ``*.parquet``, a list of files, or a
    ``ParquetDataset``."""
    from .dataset import ParquetDataset

    if isinstance(paths_or_dataset, ParquetDataset):
        return [paths_or_dataset.path]
    if isinstance(paths_or_dataset, (str, pathlib.Path)):
        p = pathlib.Path(paths_or_dataset)
        if p.is_dir():
            return sorted(str(f) for f in p.glob("*.parquet"))
        return [str(p)]
    return [str(p) for p in paths_or_dataset]


def _writable(arr: np.ndarray) -> np.ndarray:
    # Arrow hands out read-only views of its buffers; torch.from_numpy warns
    # on those, so no such array leaves the loader
    return arr if arr.flags.writeable else arr.copy()


def _table_to_columns(table, schema: Schema, max_sequence_length: int,
                      ragged: bool = False) -> NDArrayDict:
    """Arrow table → dict of dense numpy arrays; list columns are padded (or
    cut, keeping the first items) to ``max_sequence_length``, or with
    ``ragged`` kept as ``name__values``/``name__offsets`` pairs (what
    packing takes)."""
    import pyarrow as pa

    out: NDArrayDict = {}
    names = set(table.column_names)
    for col in schema:
        if col.name not in names:
            continue
        arr = table.column(col.name)
        chunked = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
        if pa.types.is_list(chunked.type) or pa.types.is_large_list(chunked.type):
            flat = np.asarray(chunked.flatten().to_numpy(zero_copy_only=False))
            offsets = np.asarray(chunked.offsets.to_numpy(zero_copy_only=False))
            # a sliced array keeps a nonzero first offset: flatten() rebases
            # the values but .offsets does not
            if len(offsets) and offsets[0] != 0:
                offsets = offsets - offsets[0]
            if ragged:
                out[f"{col.name}__values"] = flat
                out[f"{col.name}__offsets"] = offsets
            else:
                out[col.name] = pad_ragged(flat, offsets, max_sequence_length)
        else:
            out[col.name] = _writable(np.asarray(chunked.to_numpy(zero_copy_only=False)))
    return out


def _prefetched(iter_fn, prefetch: int) -> Iterator[NDArrayDict]:
    """Run ``iter_fn()`` on a background thread, ``prefetch`` batches ahead.

    The consumer may stop early (a ``max_steps`` break, ``predict``, a probe
    of the first batch): the generator's ``finally`` sets a stop event that
    the producer polls, so no thread stays blocked on a full queue. An
    exception in the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in iter_fn():
                if not put(b):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises
            put(e)
            return
        put(end)

    t = threading.Thread(target=producer, daemon=True, name=PREFETCH_THREAD_NAME)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


@dataloader_registry.register("parquet")
@dataloader_registry.register("merlin")  # the reference's engine name
class ParquetDataLoader(T4RecDataLoader):
    """Columns held in memory (decoded from Parquet files by
    ``from_schema``), yielded as shuffled fixed-shape batches.

    ``global_rank``/``global_size`` stripe rows across processes;
    ``prefetch`` batches are assembled ahead on a background thread."""

    def __init__(self, data: NDArrayDict, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, global_rank: int = 0,
                 global_size: int = 1, prefetch: int = 2):
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.global_size = global_size
        self._epoch = 0
        self._skip_batches = 0
        data = {k: np.asarray(v) for k, v in data.items()}
        n = len(next(iter(data.values())))
        if global_size > 1:
            idx = np.arange(global_rank, n, global_size)
            data = {k: v[idx] for k, v in data.items()}
        self.data = data
        self.num_rows = len(next(iter(data.values())))
        # every process must yield the same number of batches, so __len__
        # counts the global rows, not this process's stripe
        self.total_rows = n
        self.prefetch = prefetch

    @classmethod
    def from_schema(cls, schema: Schema, paths_or_dataset, batch_size: int,
                    max_sequence_length: Optional[int] = None, shuffle: bool = True,
                    drop_last: bool = True, seed: int = 0, global_rank: int = 0,
                    global_size: int = 1, pack: bool = False,
                    **kwargs) -> "ParquetDataLoader":
        import pyarrow.parquet as pq

        max_len = max_sequence_length or schema.sequence_length(default=20)
        parts = [_table_to_columns(pq.read_table(path), schema, max_len, ragged=pack)
                 for path in _resolve_paths(paths_or_dataset)]
        if not parts:
            raise ValueError(f"No parquet files found in {paths_or_dataset!r}")
        data = _merge_parts(parts, pack)
        if pack:
            # every file's sessions packed at once, before the rows stripe
            data = pack_sessions(data, max_len=max_len, item_id_col=schema.item_id_column_name)
        return cls(data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                   seed=seed, global_rank=global_rank, global_size=global_size,
                   prefetch=kwargs.get("prefetch", 2))

    def __len__(self) -> int:
        gbatch = self.batch_size * self.global_size
        if self.drop_last:
            return max(1, self.total_rows // gbatch) if self.total_rows >= gbatch else 1
        return -(-self.total_rows // gbatch)

    def _epoch_order(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(self.num_rows)
        else:
            order = np.arange(self.num_rows)
        # fill slots are marked -1 and gathered as all-zero rows
        total = len(self) * self.batch_size
        if total > self.num_rows:
            order = np.concatenate([order, np.full(total - self.num_rows, -1, order.dtype)])
        return order[:total]

    def set_state(self, epoch: int, batches_consumed: int) -> None:
        """Position the loader for a mid-epoch resume: the next iteration
        replays epoch ``epoch``'s order and skips its first
        ``batches_consumed`` batches."""
        self._epoch = epoch
        self._skip_batches = batches_consumed

    def _iter_batches(self) -> Iterator[NDArrayDict]:
        order = self._epoch_order()
        self._epoch += 1
        skip = self._skip_batches * self.batch_size
        self._skip_batches = 0
        use_native = native_gathers(self.data, self.batch_size)
        for start in range(skip, len(order), self.batch_size):
            sel = order[start:start + self.batch_size]
            fill = sel < 0
            if fill.any():
                out = {k: v[np.where(fill, 0, sel)] for k, v in self.data.items()}
                for v in out.values():
                    v[fill] = 0
                yield out
            elif use_native:
                yield {k: native.gather_rows(v, sel) for k, v in self.data.items()}
            else:
                yield {k: v[sel] for k, v in self.data.items()}

    def __iter__(self) -> Iterator[NDArrayDict]:
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        yield from _prefetched(self._iter_batches, self.prefetch)


# the loader over numpy columns already in memory (what ``Trainer`` builds
# from a dict of columns)
InMemoryDataLoader = ParquetDataLoader


@dataloader_registry.register("parquet_streaming")
class StreamingParquetDataLoader(T4RecDataLoader):
    """Row groups read on demand into a bounded shuffle buffer, for files
    larger than host memory.

    - deterministic in ``(seed, epoch)``: the row-group order is shuffled
      per epoch and the rows within each filled buffer, so a replayed epoch
      gives the same batches and ``set_state`` resumes exactly;
    - row groups stripe across processes when there are at least
      ``global_size`` of them, else rows stripe within the shared groups;
      ``__len__`` is sized to the largest stripe, and a shorter one pads
      with all-zero batches;
    - the remainder below one batch is zero-filled unless ``drop_last``;
    - ``pack=True`` packs each buffer on its own; ``__len__`` is then an
      estimate from the first packed buffer's sessions per row until one
      whole epoch has been counted.
    """

    def __init__(self, paths: List[str], schema: Schema, batch_size: int,
                 max_sequence_length: int, shuffle: bool = True, seed: int = 0,
                 global_rank: int = 0, global_size: int = 1, pack: bool = False,
                 buffer_rows: int = 65536, prefetch: int = 2, drop_last: bool = True):
        import pyarrow.parquet as pq

        if pack and global_size > 1:
            raise ValueError(
                "StreamingParquetDataLoader(pack=True) does not support "
                "multi-process training: per-host packing produces "
                "nondeterministic per-host batch counts, which would "
                "desynchronize the cross-process batch collective. Use the "
                "in-memory ParquetDataLoader(pack=True) (packs globally "
                "before striping) or stream unpacked."
            )
        self.drop_last = drop_last
        self.paths = list(paths)
        self.schema = schema
        self.batch_size = int(batch_size)
        self.max_len = max_sequence_length
        self.shuffle = shuffle
        self.seed = seed
        self.global_rank = global_rank
        self.global_size = global_size
        self.pack = pack
        self.buffer_rows = max(buffer_rows, batch_size)
        self.prefetch = prefetch
        self._epoch = 0
        self._skip_batches = 0
        self._exact_len: Optional[int] = None  # a packed epoch's batches, once counted
        self._pack_ratio: Optional[float] = None  # sessions per packed row so far
        # (path, row group, rows) from the footers alone: nothing is decoded here
        self._groups: List[tuple] = []
        for path in self.paths:
            meta = pq.ParquetFile(path).metadata
            for g in range(meta.num_row_groups):
                self._groups.append((path, g, meta.row_group(g).num_rows))
        if not self._groups:
            raise ValueError(f"No parquet row groups under {self.paths!r}")
        self._stripe_groups = len(self._groups) >= global_size
        self.total_rows = sum(g[2] for g in self._groups)
        if self._stripe_groups:
            self._my_groups = self._groups[global_rank::global_size]
            self.num_rows = sum(g[2] for g in self._my_groups)
            self._max_local_rows = max(sum(g[2] for g in self._groups[r::global_size])
                                       for r in range(global_size))
        else:
            self._my_groups = list(self._groups)
            self.num_rows = len(range(global_rank, self.total_rows, global_size))
            self._max_local_rows = -(-self.total_rows // global_size)

    @classmethod
    def from_schema(cls, schema: Schema, paths_or_dataset, batch_size: int,
                    max_sequence_length: Optional[int] = None, shuffle: bool = True,
                    drop_last: bool = True, seed: int = 0, global_rank: int = 0,
                    global_size: int = 1, pack: bool = False, buffer_rows: int = 65536,
                    **kwargs) -> "StreamingParquetDataLoader":
        max_len = max_sequence_length or schema.sequence_length(default=20)
        return cls(_resolve_paths(paths_or_dataset), schema, batch_size=batch_size,
                   max_sequence_length=max_len, shuffle=shuffle, seed=seed,
                   global_rank=global_rank, global_size=global_size, pack=pack,
                   buffer_rows=buffer_rows, drop_last=drop_last,
                   prefetch=kwargs.get("prefetch", 2))

    def __len__(self) -> int:
        if not self.pack:
            if not self.drop_last:
                return -(-self._max_local_rows // self.batch_size)
            return max(self._max_local_rows // self.batch_size, 1)
        if self._exact_len is not None:
            return self._exact_len
        if self._pack_ratio is None:
            # the first buffer's sessions per packed row
            for _ in self._iter_batches(peek_ratio_only=True):
                break
        packed = int(self.num_rows / max(self._pack_ratio, 1e-9))
        return max(packed // self.batch_size, 1)

    def set_state(self, epoch: int, batches_consumed: int) -> None:
        """Mid-epoch resume, as ``ParquetDataLoader.set_state``: the skipped
        batches are streamed again but not gathered."""
        self._epoch = epoch
        self._skip_batches = batches_consumed

    def _read_group(self, path: str, group: int) -> NDArrayDict:
        import pyarrow.parquet as pq

        cols = _table_to_columns(pq.ParquetFile(path).read_row_group(group), self.schema,
                                 self.max_len, ragged=self.pack)
        if not self._stripe_groups and self.global_size > 1:
            cols = {k: v[self.global_rank::self.global_size] for k, v in cols.items()}
        return cols

    def _iter_batches(self, peek_ratio_only: bool = False) -> Iterator[NDArrayDict]:
        """One epoch's batches; ``peek_ratio_only`` packs the first buffer,
        records its sessions per row and yields nothing, touching neither
        the epoch nor a pending resume."""
        epoch = self._epoch
        skip = 0
        if not peek_ratio_only:
            self._epoch += 1
            skip, self._skip_batches = self._skip_batches, 0
        rng = np.random.default_rng(self.seed + epoch)
        order = (rng.permutation(len(self._my_groups)) if self.shuffle
                 else np.arange(len(self._my_groups)))
        carry: Optional[NDArrayDict] = None  # rows short of a batch
        batches_out = 0
        sessions_in = rows_packed = 0
        pending: List[NDArrayDict] = []
        pending_rows = 0
        # unpacked: exactly len(self) batches, the same count on every
        # process; packed: as many as the buffers give
        target = None if self.pack else len(self)
        template: Optional[NDArrayDict] = None
        for pos, gi in enumerate(order):
            path, group, _ = self._my_groups[gi]
            cols = self._read_group(path, group)
            pending.append(cols)
            pending_rows += _n_rows(cols, self.pack)
            if pending_rows < self.buffer_rows and pos != len(order) - 1:
                continue
            rows = _merge_parts(pending, self.pack)
            pending, pending_rows = [], 0
            if self.pack:
                sessions_in += _n_rows(rows, ragged=True)
                rows = pack_sessions(rows, max_len=self.max_len,
                                     item_id_col=self.schema.item_id_column_name)
                rows_packed += _n_rows(rows)
                self._pack_ratio = sessions_in / max(rows_packed, 1)
                if peek_ratio_only:
                    return
            if carry is not None:
                rows = {k: np.concatenate([carry[k], rows[k]]) for k in rows}
                carry = None
            n = _n_rows(rows)
            template = rows
            perm = rng.permutation(n) if self.shuffle else np.arange(n)
            full = (n // self.batch_size) * self.batch_size
            for start in range(0, full, self.batch_size):
                sel = perm[start:start + self.batch_size]
                if target is not None and batches_out >= target:
                    warnings.warn(
                        f"StreamingParquetDataLoader: dropping {n - start} surplus local "
                        f"rows to keep the global batch count ({target}) the same on "
                        "every process; write more evenly sized row groups to avoid "
                        "data loss", stacklevel=2)
                    break
                batches_out += 1
                if batches_out > skip:
                    yield {k: v[sel] for k, v in rows.items()}
            if n > full:
                carry = {k: v[perm[full:]] for k, v in rows.items()}
        if (carry is not None and (not self.drop_last or batches_out == 0)
                and (target is None or batches_out < target)):
            pad = self.batch_size - _n_rows(carry)
            batch = {k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), dtype=v.dtype)])
                     for k, v in carry.items()}
            batches_out += 1
            if batches_out > skip:
                yield batch
        # a stripe with fewer rows than its peers still owes the other
        # processes its batches: all-zero, weightless ones
        while target is not None and batches_out < target and template is not None:
            batch = {k: np.zeros((self.batch_size, *v.shape[1:]), dtype=v.dtype)
                     for k, v in template.items()}
            batches_out += 1
            if batches_out > skip:
                yield batch
        if self.pack and skip == 0:
            self._exact_len = batches_out

    def __iter__(self) -> Iterator[NDArrayDict]:
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        yield from _prefetched(self._iter_batches, self.prefetch)


def _n_rows(cols: NDArrayDict, ragged: bool = False) -> int:
    """Rows of a batch; sessions of a ragged one (``__offsets`` pairs)."""
    if ragged:
        k = next(k for k in cols if k.endswith("__offsets"))
        return len(cols[k]) - 1
    return len(next(iter(cols.values())))


def _merge_parts(parts: List[NDArrayDict], ragged: bool = False) -> NDArrayDict:
    """Concatenate parts' rows; a ragged part's offsets are rebased onto
    the values before it."""
    if len(parts) == 1:
        return parts[0]
    merged: NDArrayDict = {}
    for k in parts[0]:
        if ragged and k.endswith("__offsets"):
            pieces, base = [parts[0][k]], int(parts[0][k][-1])
            for p in parts[1:]:
                pieces.append(p[k][1:] + base)
                base += int(p[k][-1])
            merged[k] = np.concatenate(pieces)
        else:
            merged[k] = np.concatenate([p[k] for p in parts])
    return merged


@dataloader_registry.register("synthetic")
class SyntheticDataLoader(ParquetDataLoader):
    """Loader over sessions synthesized from the schema: needs no files."""

    @classmethod
    def from_schema(cls, schema: Schema, paths_or_dataset=None, batch_size: int = 16,
                    max_sequence_length: Optional[int] = None, num_rows: int = 256,
                    shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                    global_rank: int = 0, global_size: int = 1, pack: bool = False,
                    **kwargs) -> "SyntheticDataLoader":
        max_len = max_sequence_length or schema.sequence_length(default=20)
        data = synthetic_data(schema, num_rows=num_rows, max_session_length=max_len,
                              ragged=pack, seed=seed)
        if pack:
            data = pack_sessions(data, max_len=max_len, item_id_col=schema.item_id_column_name)
        return cls(data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                   seed=seed, global_rank=global_rank, global_size=global_size,
                   prefetch=kwargs.get("prefetch", 2))
