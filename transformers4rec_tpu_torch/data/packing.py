"""Session packing: several short sessions in one fixed-length row.

Counterpart of ``transformers4rec_tpu/data/packing.py``, in numpy on the
host, with the same output bit for bit. Sessions are short (REES46: about 11
of at most 20 positions), so much of every encoder row is padding. Packing
places several sessions into one ``max_len`` row and adds ``segment_ids``
(0 at padding, 1..n for the sessions of a row): the encoder turns segments
into a block-diagonal attention restriction with positions restarting per
segment, and the masking schemes keep labels, spans and their guarantees
inside a segment (``masking.py``, ``blocks/transformer.py``).

Training packs with ``pack_sessions=True``; evaluation with the separate
``pack_eval_sessions=True`` (per-segment last-item targets: the metric sums
equal unpacked evaluation's). Prediction and serving stay unpacked.

Rows are filled first-fit-decreasing: the longest session first, each into
the lowest-index row with room for it.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional

import numpy as np

NDArrayDict = Dict[str, np.ndarray]


def _session_lengths(data: NDArrayDict, item_id_col: str, pad: int) -> np.ndarray:
    if f"{item_id_col}__offsets" in data:
        off = np.asarray(data[f"{item_id_col}__offsets"])
        return (off[1:] - off[:-1]).astype(np.int64)
    ids = np.asarray(data[item_id_col])
    return (ids != pad).sum(axis=1).astype(np.int64)


def _dense_feature(data: NDArrayDict, name: str, lengths: np.ndarray):
    """Per-session variable-length views of a feature (ragged or dense)."""
    if f"{name}__values" in data:
        vals = np.asarray(data[f"{name}__values"])
        off = np.asarray(data[f"{name}__offsets"])
        return [vals[off[i]:off[i + 1]] for i in range(len(off) - 1)]
    dense = np.asarray(data[name])
    return [dense[i, : lengths[i]] for i in range(len(dense))]


def pack_sessions(
    data: NDArrayDict,
    max_len: int,
    item_id_col: str,
    pad: int = 0,
    min_session_len: int = 2,
    num_rows: Optional[int] = None,
) -> NDArrayDict:
    """Pack sessions into ``(B_packed, max_len)`` rows plus ``segment_ids``.

    ``data``: per-session sequence features, dense ``(N, S)`` arrays or
    ragged ``name__values``/``name__offsets`` pairs. Every feature must be
    sequential (a scalar per-session feature cannot share a packed row).
    Sessions shorter than ``min_session_len`` are dropped (they carry no
    next-item signal). ``num_rows`` cuts or pads the packed rows to a fixed
    count (all-zero fill rows, which carry no weight).
    """
    feature_names = sorted(
        {k.removesuffix("__values") for k in data if k.endswith("__values")}
        | {k for k in data if "__" not in k}
    )
    if item_id_col not in feature_names:
        raise ValueError(f"item_id_col {item_id_col!r} not in {feature_names}")
    lengths = _session_lengths(data, item_id_col, pad)
    for name in feature_names:
        f_len = _session_lengths(data, name, pad) if f"{name}__offsets" in data else None
        if f_len is not None and not np.array_equal(f_len, lengths):
            raise ValueError(
                f"feature {name!r} has per-session lengths different from "
                f"{item_id_col!r} — packing requires aligned sequence features"
            )
    for name in feature_names:
        if f"{name}__values" not in data and np.asarray(data[name]).ndim < 2:
            raise ValueError(
                f"feature {name!r} is a scalar per-session column — every "
                f"packed feature must be sequential (drop scalar columns "
                f"before packing)"
            )
    full_lengths = lengths
    keep = np.nonzero(full_lengths >= min_session_len)[0]
    if len(keep) == 0:
        raise ValueError(
            f"no sessions with length >= min_session_len ({min_session_len}) "
            f"to pack (max session length in data: "
            f"{int(full_lengths.max()) if len(full_lengths) else 0})"
        )
    lengths = np.minimum(full_lengths[keep], max_len)
    per_feature = {}
    for name in feature_names:
        views = _dense_feature(data, name, full_lengths)
        per_feature[name] = [np.asarray(views[i])[:max_len] for i in keep]

    # exact first fit (the lowest-index row with room), found through a heap
    # of row indices per remaining capacity: O(N·(max_len + log N)) where a
    # scan of the rows is O(N·rows)
    order = np.argsort(-lengths, kind="stable")
    rows: list = []  # each: the session indices of a row
    space: list = []  # each row's remaining capacity
    buckets: list = [[] for _ in range(max_len + 1)]  # heaps of row ids by capacity
    for idx in order:
        ln = int(lengths[idx])
        best_c = -1
        best_r = -1
        for c in range(ln, max_len + 1):
            if buckets[c] and (best_r < 0 or buckets[c][0] < best_r):
                best_r = buckets[c][0]
                best_c = c
        if best_r >= 0:
            heapq.heappop(buckets[best_c])
            rows[best_r].append(int(idx))
            space[best_r] -= ln
            heapq.heappush(buckets[space[best_r]], best_r)
        else:
            rows.append([int(idx)])
            space.append(max_len - ln)
            heapq.heappush(buckets[max_len - ln], len(rows) - 1)

    B = len(rows)
    out = {
        name: np.full((B, max_len), pad, dtype=np.asarray(per_feature[name][0]).dtype)
        for name in feature_names
    }
    seg = np.zeros((B, max_len), np.int32)
    for r, members in enumerate(rows):
        cursor = 0
        for s_i, idx in enumerate(members, start=1):
            ln = int(lengths[idx])
            for name in feature_names:
                out[name][r, cursor:cursor + ln] = per_feature[name][idx][:ln]
            seg[r, cursor:cursor + ln] = s_i
            cursor += ln
    out["segment_ids"] = seg

    if num_rows is not None:
        if B >= num_rows:
            out = {k: v[:num_rows] for k, v in out.items()}
        else:
            # all-zero fill rows: no loss or metric weight, where repeating
            # rows would count their sessions twice
            pad_n = num_rows - B
            out = {k: np.concatenate([v, np.zeros((pad_n, *v.shape[1:]), dtype=v.dtype)])
                   for k, v in out.items()}
    return out


def packing_stats(packed: NDArrayDict, item_id_col: str, pad: int = 0) -> dict:
    """``{"rows", "sessions", "fill"}`` of a packed batch: its rows, the
    sessions in them and the share of positions holding an item."""
    seg = packed["segment_ids"]
    fill = float((packed[item_id_col] != pad).mean())
    return {
        "rows": int(seg.shape[0]),
        "sessions": int(sum(len(np.unique(row[row > 0])) for row in seg)),
        "fill": round(fill, 4),
    }
