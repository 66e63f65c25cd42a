"""Ragged → dense padding on the host.

Counterpart of ``transformers4rec_tpu/data/padding.py``. Every ragged column
pads to one static ``(batch, max_len)`` shape; truncation keeps the FIRST
``max_len`` items of each session. ``pad_ragged`` dispatches to the C++
kernel (``native``) for the types it takes, as the JAX package does, and
runs numpy for the others or when the caller asks (``use_native=False``);
both give the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .. import native

NDArrayDict = Dict[str, np.ndarray]


def pad_ragged(values: np.ndarray, offsets: np.ndarray, max_len: int,
               use_native: bool = True) -> np.ndarray:
    """Densify one ragged column to ``(num_rows, max_len)``, zero padded:
    the native kernel for float32, int64 and int32 values unless
    ``use_native`` is False, else numpy."""
    values = np.asarray(values)
    if use_native and values.dtype in native.PAD_FNS:
        return native.pad_ragged(values, offsets, max_len)
    offsets = np.asarray(offsets).astype(np.int64)
    num_rows = len(offsets) - 1
    lengths = np.minimum(offsets[1:] - offsets[:-1], max_len)
    out = np.zeros((num_rows, max_len), dtype=values.dtype)
    # row/col target index and source index of every kept value
    row_idx = np.repeat(np.arange(num_rows), lengths)
    starts = np.repeat(offsets[:-1], lengths)
    col_idx = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    out[row_idx, col_idx] = values[starts + col_idx]
    return out


def pad_batch(batch: NDArrayDict, padding_lengths: Dict[str, int]) -> NDArrayDict:
    """Pad every ragged (``__values``/``__offsets``) column to its configured
    length; 2-D dense columns listed in ``padding_lengths`` are right-padded
    or truncated to it."""
    out: NDArrayDict = {}
    for key, val in batch.items():
        if key.endswith("__offsets"):
            continue
        if key.endswith("__values"):
            name = key[: -len("__values")]
            max_len = padding_lengths.get(name)
            if max_len is None:
                raise ValueError(f"No padding length configured for ragged column {name!r}")
            out[name] = pad_ragged(val, batch[f"{name}__offsets"], max_len)
        else:
            max_len = padding_lengths.get(key)
            if max_len is not None and val.ndim == 2 and val.shape[1] != max_len:
                fixed = np.zeros((val.shape[0], max_len), dtype=val.dtype)
                keep = min(val.shape[1], max_len)
                fixed[:, :keep] = val[:, :keep]
                out[key] = fixed
            else:
                out[key] = val
    return out


def pad_inputs(inputs: NDArrayDict, max_sequence_length: Optional[int] = None) -> NDArrayDict:
    """Model-entry padding: every column to ``max_sequence_length`` (the
    longest session in the batch when ``None``)."""
    if max_sequence_length is None:
        seq_max = 0
        for key, val in inputs.items():
            if key.endswith("__offsets"):
                seq_max = max(seq_max, int(np.max(val[1:] - val[:-1])) if len(val) > 1 else 0)
        max_sequence_length = max(seq_max, 1)
    lengths = {}
    for key in inputs:
        if key.endswith("__values"):
            lengths[key[: -len("__values")]] = max_sequence_length
        elif not key.endswith("__offsets"):
            lengths[key] = max_sequence_length
    return pad_batch(inputs, lengths)


def ragged_lengths(offsets: np.ndarray) -> np.ndarray:
    return (offsets[1:] - offsets[:-1]).astype(np.int64)


def dense_to_ragged(dense: np.ndarray, lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of ``pad_ragged``: ``(values, offsets)`` of the first
    ``lengths`` items of each row."""
    num_rows, max_len = dense.shape
    lengths = np.minimum(lengths, max_len)
    offsets = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    values = (np.concatenate([dense[i, : lengths[i]] for i in range(num_rows)]) if num_rows
              else dense.reshape(0))
    return values, offsets
