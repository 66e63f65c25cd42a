"""Host ETL over interaction data frames (pandas and numpy).

Counterpart of ``transformers4rec_tpu/utils/data_utils.py``; the same frame
gives the same tables:

- ``categorify`` encodes raw values with NVTabular's codes (0 padding,
  1 null, 2 out of vocabulary, 3 and up by descending frequency), and
  ``build_category_codes``, ``encode_with_categories``, ``save_categories``,
  ``load_categories`` and ``categorify_schema`` apply, store and describe
  that mapping;
- ``remove_consecutive_interactions``, ``add_item_first_seen_col_to_df`` and
  ``session_aggregator`` turn one row per interaction into one row per
  session with list columns;
- ``save_time_based_splits`` writes ``{t}/train.parquet``,
  ``{t}/valid.parquet`` and ``{t}/test.parquet`` per time window, and
  ``etl_interactions_to_time_splits`` runs the whole recipe from raw
  interactions; ``utils.examples_utils.fit_and_evaluate`` reads its output.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import warnings
from typing import Dict, Optional, Sequence, Union

import numpy as np

from ..schema import IntDomain, Schema

FIRST_SEEN_ITEM_COL_NAME = "item_ts_first"

# NVTabular's Categorify: nulls encode to 1, out-of-vocabulary values to 2;
# 0 is kept for padding and categories start from 3
CATEGORIFY_PAD_INDEX = 0
CATEGORIFY_NULL_INDEX = 1
CATEGORIFY_OOV_INDEX = 2
CATEGORIFY_START_INDEX = 3


def categorify(df, columns: Sequence[str], start_index: int = CATEGORIFY_START_INDEX,
               freq_threshold: int = 0, max_size: Optional[int] = None):
    """Encode raw categorical values to contiguous ids, as NVTabular's
    ``Categorify`` does: by descending frequency (ties by raw value) from
    ``start_index``; values seen fewer than ``freq_threshold`` times or
    beyond ``max_size`` distinct ones become out of vocabulary.

    Returns ``(encoded_df, mappings)``: ``mappings[col][i]`` is the raw value
    encoded as ``start_index + i`` (the layout of NVTabular's
    ``unique.<col>.parquet``)."""
    df = df.copy()
    mappings: Dict[str, np.ndarray] = {}
    for col in columns:
        order = df[col].value_counts(dropna=True).reset_index()
        order.columns = ["value", "count"]
        order = order.sort_values(["count", "value"], ascending=[False, True])
        if freq_threshold > 0:
            order = order[order["count"] >= freq_threshold]
        if max_size is not None:
            order = order.iloc[:max_size]
        raw_values = order["value"].to_numpy()
        mappings[col] = raw_values
        if any(v == 0 or v == "" for v in raw_values.tolist()):
            warnings.warn(
                f"column {col!r} contains raw value 0/'' — it gets a real code at "
                "training time but serving treats 0/'' as padding, so that one raw id "
                "cannot be addressed at inference. Remap it upstream.", stacklevel=2)
        code = {v: start_index + i for i, v in enumerate(raw_values)}
        enc = df[col].map(code).where(~df[col].isna(), CATEGORIFY_NULL_INDEX)
        df[col] = enc.fillna(CATEGORIFY_OOV_INDEX).astype("int64")
    return df, mappings


def build_category_codes(raw_values, start_index: int = CATEGORIFY_START_INDEX):
    """Raw value → id lookup (a pandas Series over a hash index) for a
    ``categorify`` mapping; build it once per column and reuse it."""
    import pandas as pd

    return pd.Series(np.arange(len(raw_values), dtype=np.int64) + start_index,
                     index=pd.Index(raw_values))


def encode_with_categories(values, raw_values, start_index: int = CATEGORIFY_START_INDEX,
                           zero_is_padding: bool = True):
    """Apply a ``categorify`` mapping (or a ``build_category_codes`` Series)
    to new data: nulls → the null id, unseen values → the OOV id, and with
    ``zero_is_padding`` raw 0/"" → 0."""
    import pandas as pd

    code = (raw_values if isinstance(raw_values, pd.Series)
            else build_category_codes(raw_values, start_index))
    arr = np.asarray(values)
    flat = pd.Series(arr.ravel())
    isna = flat.isna().to_numpy()
    enc = flat.map(code).fillna(CATEGORIFY_OOV_INDEX).astype("int64").to_numpy()
    enc = np.where(isna, CATEGORIFY_NULL_INDEX, enc)
    if zero_is_padding and not isna.all():
        flat_np = flat.to_numpy()
        is_pad = np.zeros(len(flat_np), bool)
        for pad in (0, ""):
            try:
                is_pad |= np.asarray(flat_np == pad, bool) & ~isna
            except (TypeError, ValueError):  # incomparable dtypes
                pass
        enc = np.where(is_pad, CATEGORIFY_PAD_INDEX, enc)
    return enc.reshape(arr.shape)


def save_categories(mappings: Dict[str, np.ndarray], path: str) -> str:
    """Write ``unique.<col>.parquet`` files (NVTabular's ``categories/``
    layout: row i holds the raw value encoded as ``start_index + i``)."""
    import pandas as pd

    os.makedirs(path, exist_ok=True)
    for col, raw_values in mappings.items():
        pd.DataFrame({col: raw_values}).to_parquet(os.path.join(path, f"unique.{col}.parquet"))
    return path


def load_categories(path: str) -> Dict[str, np.ndarray]:
    """Read the mappings ``save_categories`` (or NVTabular) wrote."""
    import pandas as pd

    mappings = {}
    for f in sorted(os.listdir(path)):
        if f.startswith("unique.") and f.endswith(".parquet"):
            col = f[len("unique."):-len(".parquet")]
            mappings[col] = pd.read_parquet(os.path.join(path, f))[col].to_numpy()
    return mappings


def categorify_schema(schema: Schema, mappings: Dict[str, np.ndarray],
                      start_index: int = CATEGORIFY_START_INDEX) -> Schema:
    """The schema with each mapped column's cardinality after encoding
    (``int_domain.max = start_index + num_uniques - 1``)."""
    out = Schema([dataclasses.replace(c) for c in schema])
    for col in out:
        if col.name in mappings:
            hi = start_index + len(mappings[col.name]) - 1
            col.int_domain = IntDomain(name=col.name, min=0, max=int(hi), is_categorical=True)
    return out


def remove_consecutive_interactions(df, session_id_col="session_id", item_id_col="item_id",
                                    timestamp_col="timestamp"):
    """Drop consecutive repetitions of an item within a session."""
    df = df.sort_values([session_id_col, timestamp_col])
    same_session = df[session_id_col] == df[session_id_col].shift(1)
    same_item = df[item_id_col] == df[item_id_col].shift(1)
    return df[~(same_session & same_item)]


def add_item_first_seen_col_to_df(df, item_id_column="item_id", timestamp_column="timestamp",
                                  first_seen_column_name=FIRST_SEEN_ITEM_COL_NAME):
    """Add each item's first timestamp as a column."""
    firsts = (df.groupby(item_id_column).agg({timestamp_column: "min"}).reset_index()
              .rename(columns={timestamp_column: first_seen_column_name}))
    return df.merge(firsts, on=[item_id_column], how="left")


def session_aggregator(schema: Schema, data, maximum_length: int = 20, minimum_length: int = 2,
                       session_id_col: str = "session_id",
                       timestamp_col: Optional[str] = "timestamp", keep: str = "first"):
    """One row per session: the schema's columns as lists in time order,
    cut to ``maximum_length`` (``keep="first"`` keeps the earliest items,
    ``"last"`` the latest), sessions shorter than ``minimum_length``
    dropped."""
    import pandas as pd

    if keep not in ("first", "last"):
        raise ValueError(f"keep must be 'first' or 'last', got {keep!r}")
    cols = [c.name for c in schema if c.name in data.columns]
    sort_cols = [session_id_col] + ([timestamp_col] if timestamp_col in data.columns else [])
    df = data.sort_values(sort_cols, kind="stable")
    sid = df[session_id_col].to_numpy()
    if len(sid) == 0:
        return pd.DataFrame({session_id_col: [], **{c: [] for c in cols}})
    # session boundaries on the sorted ids
    change = np.nonzero(sid[1:] != sid[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(sid)]])
    lens = ends - starts
    m = lens >= minimum_length
    starts, ends, lens = starts[m], ends[m], lens[m]
    trim = np.minimum(lens, maximum_length)
    if keep == "first":
        ends = starts + trim
    else:
        starts = ends - trim
    out = {session_id_col: sid[starts]}
    for c in cols:
        arr = df[c].to_numpy()
        out[c] = [arr[s:e].tolist() for s, e in zip(starts, ends)]
    return pd.DataFrame(out)


def _read_frame(data):
    import pandas as pd

    path = str(data)
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".parquet"))
        return pd.concat([pd.read_parquet(f) for f in files], ignore_index=True)
    return pd.read_parquet(path)


def save_time_based_splits(data, output_dir: str, partition_col: str = "day_idx",
                           timestamp_col: str = "ts/first", test_size: float = 0.1,
                           val_size: float = 0.1, overwrite: bool = True, seed: int = 1,
                           pad_digits: int = 0):
    """Write one folder per value of ``partition_col`` (``pad_digits`` pads
    the name with zeros) holding ``train.parquet``, ``valid.parquet`` and
    ``test.parquet``: the window's rows sorted by ``timestamp_col``, each
    routed by a uniform draw seeded per window. ``data`` is a DataFrame or a
    Parquet file or directory."""
    if isinstance(data, (str, os.PathLike)):
        data = _read_frame(data)
    if partition_col not in data.columns:
        raise ValueError(f"partition_col {partition_col!r} not in dataframe")
    train_size = 1.0 - val_size - test_size
    if train_size < 0:
        raise ValueError("train_size cannot be negative.")
    if overwrite and os.path.exists(output_dir):
        shutil.rmtree(output_dir)

    for window, df in data.groupby(partition_col, sort=True):
        if timestamp_col in df.columns:
            df = df.sort_values(timestamp_col)
        try:
            name = str(int(window)) if float(window) == int(window) else str(window)
        except (TypeError, ValueError):  # a partition value that is no number
            name = str(window)
        if pad_digits:
            name = name.zfill(pad_digits)
        out_dir = os.path.join(output_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        u = np.random.RandomState(seed).rand(len(df))
        df[u <= train_size].to_parquet(os.path.join(out_dir, "train.parquet"))
        df[(u > train_size) & (u <= train_size + val_size)].to_parquet(
            os.path.join(out_dir, "valid.parquet"))
        df[u > 1.0 - test_size].to_parquet(os.path.join(out_dir, "test.parquet"))


def etl_interactions_to_time_splits(
    raw, schema: Schema, output_dir: str, num_windows: Optional[int] = None,
    day_col: Optional[str] = None, session_id_col: str = "session_id",
    item_id_col: Optional[str] = None, timestamp_col: str = "timestamp",
    maximum_length: int = 20, minimum_length: int = 2, test_size: float = 0.1,
    val_size: float = 0.1, seed: int = 1, pad_digits: int = 0,
    categorify_columns: Optional[Union[bool, Sequence[str]]] = None,
    categorify_freq_threshold: int = 0, categorify_max_size: Optional[int] = None,
    keep: str = "first",
) -> str:
    """Raw interactions (one row each; a DataFrame or a Parquet path) →
    ``{t}/train.parquet``, ``valid.parquet`` and ``test.parquet`` windows.

    Optional ``categorify`` (``True``: every categorical schema column in
    the frame; the mapping goes to ``{output_dir}/categories`` and the
    encoded schema to ``{output_dir}/schema.pbtxt``), then consecutive
    repeats dropped, the item first-seen column, session aggregation and
    ``save_time_based_splits``. A session's window is given by its first
    timestamp (``num_windows`` equal spans, 1-based) or by ``day_col``.
    Returns ``output_dir``."""
    import pandas as pd

    if isinstance(raw, (str, os.PathLike)):
        raw = pd.read_parquet(str(raw))
    item_id_col = item_id_col or schema.item_id_column_name

    mappings = None
    if categorify_columns:
        cols = ([c.name for c in schema if c.is_categorical and c.name in raw.columns]
                if categorify_columns is True else list(categorify_columns))
        raw, mappings = categorify(raw, cols, freq_threshold=categorify_freq_threshold,
                                   max_size=categorify_max_size)
        schema = categorify_schema(schema, mappings)

    df = remove_consecutive_interactions(raw, session_id_col, item_id_col, timestamp_col)
    df = add_item_first_seen_col_to_df(df, item_id_col, timestamp_col)

    starts = df.groupby(session_id_col)[timestamp_col].min().rename("ts/first")
    if day_col is not None:
        days = df.groupby(session_id_col)[day_col].min().rename("day_idx")
    else:
        n = num_windows or 2
        lo, hi = float(starts.min()), float(starts.max())
        span = max(hi - lo, 1e-9)
        days = (((starts - lo) / span * n).clip(upper=n - 1).astype(int) + 1).rename("day_idx")

    sessions = session_aggregator(schema, df, maximum_length=maximum_length,
                                  minimum_length=minimum_length, session_id_col=session_id_col,
                                  timestamp_col=timestamp_col, keep=keep)
    sessions = sessions.merge(starts, on=session_id_col).merge(days, on=session_id_col)
    save_time_based_splits(sessions, output_dir, partition_col="day_idx",
                           timestamp_col="ts/first", test_size=test_size, val_size=val_size,
                           seed=seed, pad_digits=pad_digits)
    if mappings is not None:
        save_categories(mappings, os.path.join(output_dir, "categories"))
        schema.to_proto_text_file(os.path.join(output_dir, "schema.pbtxt"))
    return output_dir
