"""Schema-driven synthetic session data (numpy only).

Counterpart of ``transformers4rec_tpu/data/synthetic.py``: the same schema
and, for the same seed, the same draws, so both packages can be fed one
batch. Dense mode gives ``{name: (num_rows, seq_len)}`` arrays; ragged mode
gives ``{name}__values`` / ``{name}__offsets`` pairs (the Merlin dataloader
convention).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..schema import ColumnSchema, Schema, Tags, ValueCount

NDArrayDict = Dict[str, np.ndarray]


def synthetic_ecommerce_data_schema(
    num_items: int = 10000,
    num_categories: int = 100,
    max_session_length: int = 20,
) -> Schema:
    """Small e-commerce session schema: item_id + category + 2 continuous features."""
    return Schema(
        [
            ColumnSchema.create_categorical(
                "item_id",
                num_items=num_items,
                min_index=1,
                value_count=ValueCount(2, max_session_length),
                tags=[Tags.ITEM_ID, Tags.ITEM, Tags.LIST],
            ),
            ColumnSchema.create_categorical(
                "category",
                num_items=num_categories,
                min_index=1,
                value_count=ValueCount(2, max_session_length),
                tags=[Tags.ITEM, Tags.LIST],
            ),
            ColumnSchema.create_continuous(
                "item_recency",
                min_value=0.0,
                max_value=1.0,
                value_count=ValueCount(2, max_session_length),
                tags=[Tags.ITEM, Tags.LIST, Tags.TIME],
            ),
            ColumnSchema.create_continuous(
                "weekday_sin",
                min_value=0.0,
                max_value=1.0,
                value_count=ValueCount(2, max_session_length),
                tags=[Tags.SESSION, Tags.LIST, Tags.TIME],
            ),
        ]
    )


def _sample_lengths(rng: np.random.Generator, num_rows: int, min_len: int, max_len: int):
    if min_len >= max_len:
        return np.full(num_rows, max_len, dtype=np.int64)
    return rng.integers(min_len, max_len + 1, size=num_rows).astype(np.int64)


def synthetic_data(
    schema: Schema,
    num_rows: int = 100,
    max_session_length: Optional[int] = None,
    ragged: bool = False,
    min_session_length: int = 2,
    seed: int = 0,
    item_popularity: str = "lognormal",
) -> NDArrayDict:
    """Synthesize a batch of feature arrays from a schema.

    Categorical ids are drawn from a log-normal popularity distribution over
    ``[min_index or 1, cardinality)``; 0 is reserved for padding.
    ``item_popularity="sessionized"`` draws one anchor item per session plus
    a local walk around it; ``"uniform"`` draws ids uniformly.
    """
    rng = np.random.default_rng(seed)
    seq_len = max_session_length or schema.sequence_length(default=20)
    lengths = _sample_lengths(rng, num_rows, min_session_length, seq_len)
    out: NDArrayDict = {}

    for col in schema:
        is_list = col.is_list
        if is_list:
            n = int(lengths.sum()) if ragged else num_rows * seq_len
        else:
            n = num_rows

        if col.is_categorical:
            card = col.cardinality or 2
            low = max(1, col.int_domain.min if col.int_domain else 1)
            high = max(low + 1, card)
            is_item = Tags.ITEM_ID in col.tags
            if item_popularity == "sessionized" and is_item and is_list:
                raw = rng.lognormal(3.0, 1.0, size=num_rows)
                anchors = (
                    low + (raw / raw.max()) * (high - 1 - low)
                ).astype(np.int64)
                window = max(5, (high - low) // 4000)
                reps = lengths if ragged else np.full(num_rows, seq_len)
                walk = rng.integers(-window, window + 1, size=n)
                ids = np.repeat(anchors, reps) + walk
                ids = np.clip(ids, low, high - 1)
            elif item_popularity in ("lognormal", "sessionized"):
                raw = rng.lognormal(3.0, 1.0, size=n)
                ids = (low + (raw / raw.max()) * (high - 1 - low)).astype(np.int64)
                ids = np.clip(ids, low, high - 1)
            else:
                ids = rng.integers(low, high, size=n).astype(np.int64)
            values = ids
        elif col.type == 2:  # INT continuous
            lo = col.int_domain.min if col.int_domain else 0
            hi = max(lo + 1, col.int_domain.max if col.int_domain else 1)
            values = rng.integers(lo, hi + 1, size=n).astype(np.int64)
        else:
            lo = col.float_domain.min if col.float_domain else 0.0
            hi = col.float_domain.max if col.float_domain else 1.0
            values = rng.uniform(lo, hi, size=n).astype(np.float32)

        if not is_list:
            out[col.name] = values
            continue

        if ragged:
            offsets = np.zeros(num_rows + 1, dtype=np.int32)
            np.cumsum(lengths, out=offsets[1:])
            out[f"{col.name}__values"] = values
            out[f"{col.name}__offsets"] = offsets
        else:
            dense = values.reshape(num_rows, seq_len)
            # zero out positions beyond each session's length (0 = padding id)
            mask = np.arange(seq_len)[None, :] < lengths[:, None]
            dense = np.where(mask, dense, np.zeros_like(dense))
            out[col.name] = dense

    return out


def generate_item_interactions(num_interactions: int, schema: Schema, seed: int = 0):
    """One row per interaction as a pandas DataFrame: ``session_id``,
    ``timestamp``, the item id (log-normal popularity) and a column for each
    other schema feature (categorical ones derived from the item id, so an
    item always carries the same side features)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    data: Dict[str, np.ndarray] = {}
    data["session_id"] = np.sort(rng.integers(1, max(2, num_interactions // 8), num_interactions))
    data["timestamp"] = np.sort(rng.integers(1_600_000_000, 1_610_000_000, num_interactions))

    item_col = schema.item_id_column
    item_card = item_col.cardinality or 1000
    raw = rng.lognormal(3.0, 1.0, size=num_interactions)
    item_ids = (1 + (raw / raw.max()) * (item_card - 2)).astype(np.int64)
    data[item_col.name] = np.clip(item_ids, 1, item_card - 1)

    for col in schema:
        if col.name in data:
            continue
        if col.is_categorical:
            card = col.cardinality or 2
            data[col.name] = 1 + (data[item_col.name] * 2654435761 % max(1, card - 1))
        elif col.type == 2:
            lo = col.int_domain.min if col.int_domain else 0
            hi = max(lo + 1, col.int_domain.max if col.int_domain else 1)
            data[col.name] = rng.integers(lo, hi + 1, num_interactions)
        else:
            lo = col.float_domain.min if col.float_domain else 0.0
            hi = col.float_domain.max if col.float_domain else 1.0
            data[col.name] = rng.uniform(lo, hi, num_interactions).astype(np.float32)
    return pd.DataFrame(data)


def interactions_to_sessions(df, schema: Schema, max_session_length: int = 20,
                             min_session_length: int = 2):
    """Group interactions by ``session_id`` into one row per session with a
    list cell per schema column, in time order, cut to
    ``max_session_length`` and keeping sessions of at least
    ``min_session_length``."""
    import pandas as pd

    list_cols = [c.name for c in schema if c.name in df.columns]
    rows = {c: [] for c in list_cols}
    session_ids = []
    for sid, g in df.sort_values("timestamp").groupby("session_id"):
        if len(g) < min_session_length:
            continue
        session_ids.append(sid)
        for c in list_cols:
            rows[c].append(list(g[c].to_numpy()[:max_session_length]))
    return pd.DataFrame({"session_id": session_ids, **rows})
