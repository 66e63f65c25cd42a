"""Bundled test datasets.

Counterpart of ``transformers4rec_tpu/data/testing.py``: three small
schema-and-Parquet fixtures (an item-id sequence with side features, a
tabular set with a binary target, a multi-task music-streaming set), made
from a seed on first use and kept under ``$T4R_TESTING_DATA_DIR`` (default
``~/.cache/transformers4rec_tpu_torch``). The same ``(name, num_rows,
seed)`` gives the same table as the JAX package.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from ..schema import ColumnSchema, Schema, Tags, ValueCount
from .dataset import ParquetDataset
from .synthetic import synthetic_data

_CACHE = pathlib.Path(
    os.environ.get("T4R_TESTING_DATA_DIR", "~/.cache/transformers4rec_tpu_torch")
).expanduser()


def _yoochoose_like_schema() -> Schema:
    """Item id, category and recency/time features."""
    sl = ValueCount(2, 20)
    return Schema([
        ColumnSchema.create_categorical(
            "item_id", num_items=51996, min_index=1, value_count=sl,
            tags=[Tags.ITEM_ID, Tags.ITEM, Tags.LIST]),
        ColumnSchema.create_categorical(
            "category", num_items=332, min_index=1, value_count=sl,
            tags=[Tags.ITEM, Tags.LIST]),
        ColumnSchema.create_continuous(
            "item_recency", min_value=0.0, max_value=1.0, value_count=sl,
            tags=[Tags.ITEM, Tags.LIST, Tags.TIME]),
        ColumnSchema.create_continuous(
            "timestamp/age_days", min_value=0.0, max_value=1.0, value_count=sl,
            tags=[Tags.ITEM, Tags.LIST, Tags.TIME]),
        ColumnSchema.create_continuous(
            "timestamp/weekday/sin", min_value=0.0, max_value=1.0, value_count=sl,
            tags=[Tags.SESSION, Tags.LIST, Tags.TIME]),
    ])


def _tabular_schema() -> Schema:
    """Non-sequential tabular data with a binary target."""
    return Schema([
        ColumnSchema.create_categorical(
            "user_id", num_items=1000, min_index=1, tags=[Tags.USER_ID, Tags.USER]),
        ColumnSchema.create_categorical(
            "item_id", num_items=5000, min_index=1, tags=[Tags.ITEM_ID, Tags.ITEM]),
        ColumnSchema.create_categorical(
            "user_country", num_items=50, min_index=1, tags=[Tags.USER]),
        ColumnSchema.create_continuous(
            "user_age", min_value=18.0, max_value=90.0, tags=[Tags.USER]),
        ColumnSchema.create_continuous(
            "click", is_float=False, min_value=0, max_value=1,
            tags=[Tags.TARGET, Tags.BINARY_CLASSIFICATION]),
    ])


def _music_streaming_schema() -> Schema:
    """Multi-task sequential data."""
    sl = ValueCount(2, 20)
    return Schema([
        ColumnSchema.create_categorical(
            "item_id", num_items=10000, min_index=1, value_count=sl,
            tags=[Tags.ITEM_ID, Tags.ITEM, Tags.LIST]),
        ColumnSchema.create_categorical(
            "genres", num_items=100, min_index=1, value_count=sl,
            tags=[Tags.ITEM, Tags.LIST]),
        ColumnSchema.create_continuous(
            "position", min_value=0.0, max_value=1.0, value_count=sl,
            tags=[Tags.ITEM, Tags.LIST]),
        ColumnSchema.create_continuous(
            "click", is_float=False, min_value=0, max_value=1,
            tags=[Tags.TARGET, Tags.BINARY_CLASSIFICATION]),
        ColumnSchema.create_continuous(
            "play_percentage", min_value=0.0, max_value=1.0,
            tags=[Tags.TARGET, Tags.REGRESSION]),
    ])


class TestingDataset(ParquetDataset):
    """A schema-and-Parquet fixture, synthesized from a seed on first
    access."""

    __test__ = False  # not a test class, whatever its name

    def __init__(self, name: str, schema: Schema, num_rows: int = 500, seed: int = 11):
        self._name = name
        self._num_rows = num_rows
        self._seed = seed
        self._schema = schema
        self._generated = False

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def path(self) -> str:
        self._ensure()
        return str(_CACHE / self._name / "data.parquet")

    @property
    def schema_path(self) -> str:
        self._ensure()
        return str(_CACHE / self._name / "schema.json")

    def _ensure(self) -> None:
        if self._generated:
            return
        d = _CACHE / self._name
        d.mkdir(parents=True, exist_ok=True)
        pq_path = d / "data.parquet"
        if not pq_path.exists():
            import pandas as pd

            data = synthetic_data(self._schema, num_rows=self._num_rows,
                                  max_session_length=self._schema.sequence_length(default=20),
                                  seed=self._seed)
            # one session length (from the first integer sequence column) for
            # every list column, so the features stay aligned with the items
            lengths = None
            for col in self._schema:
                arr = data[col.name]
                if arr.ndim == 2 and np.issubdtype(arr.dtype, np.integer):
                    lengths = (arr != 0).sum(axis=1)
                    break
            frame = {}
            for col in self._schema:
                arr = data[col.name]
                if arr.ndim == 2:
                    n_rows = np.full(len(arr), arr.shape[1]) if lengths is None else lengths
                    frame[col.name] = [list(row[: max(int(n), 2)])
                                       for row, n in zip(arr, n_rows)]
                else:
                    frame[col.name] = arr
            pd.DataFrame(frame).to_parquet(pq_path)
            self._schema.to_json_file(str(d / "schema.json"))
        self._generated = True

    def __repr__(self):
        return f"TestingDataset({self._name!r}, rows={self._num_rows})"


tabular_sequence_testing_data = TestingDataset("yoochoose_like", _yoochoose_like_schema())
tabular_testing_data = TestingDataset("tabular", _tabular_schema())
music_streaming_testing_data = TestingDataset("music_streaming", _music_streaming_schema())
