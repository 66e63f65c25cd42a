"""Datasets that bundle data with its schema.

Counterpart of ``transformers4rec_tpu/data/dataset.py``: ``Dataset`` holds a
schema and synthesizes sessions from it; ``ParquetDataset`` names a Parquet
file and its ``schema.json``, and the Parquet loaders accept it in place of
a path.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Union

from ..schema import Schema
from .synthetic import synthetic_data

PathLike = Union[str, pathlib.Path]


class Dataset:
    """A schema, and sessions synthesized from it."""

    def __init__(self, schema_path: Optional[PathLike] = None, schema: Optional[Schema] = None):
        if schema is None:
            if schema_path is None:
                raise ValueError("Provide schema or schema_path")
            schema = Schema.load(str(schema_path))
        self.schema_path = str(schema_path) if schema_path else None
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def synthetic_interactions(self, num_rows: int = 100,
                               max_session_length: Optional[int] = None,
                               ragged: bool = False, seed: int = 0):
        return synthetic_data(self.schema, num_rows=num_rows,
                              max_session_length=max_session_length, ragged=ragged, seed=seed)


class ParquetDataset(Dataset):
    """A directory (or explicit paths) holding ``data.parquet`` and
    ``schema.json``."""

    def __init__(self, dir: Optional[PathLike] = None, parquet_file_name: str = "data.parquet",
                 schema_file_name: str = "schema.json", parquet_path: Optional[PathLike] = None,
                 schema_path: Optional[PathLike] = None):
        if dir is not None:
            base = pathlib.Path(dir)
            parquet_path = parquet_path or base / parquet_file_name
            schema_path = schema_path or base / schema_file_name
        if parquet_path is None or schema_path is None:
            raise ValueError("Provide dir or both parquet_path and schema_path")
        super().__init__(schema_path=schema_path)
        self.path = str(parquet_path)

    def to_pandas(self):
        import pandas as pd

        return pd.read_parquet(self.path)
