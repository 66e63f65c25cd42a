"""Continuous feature input block.

Counterpart of ``transformers4rec_tpu/features/continuous.py``: filter the
selected columns and add a trailing feature dim.
"""

from __future__ import annotations

from typing import Dict, Sequence

from ..schema import Schema, Tags
from ..tabular.base import TabularBlock, TabularData


class ContinuousFeatures(TabularBlock):
    """Filter continuous columns; output each as (..., 1) float tensors."""

    def __init__(self, features: Sequence[str] = (), schema=None, aggregation=None):
        super().__init__(aggregation=aggregation, schema=schema)
        self.features = tuple(features)

    @classmethod
    def from_schema(cls, schema: Schema, tags=(Tags.CONTINUOUS,), **kwargs) -> "ContinuousFeatures":
        selected = schema.select_by_tag(list(tags))
        return cls(features=tuple(selected.column_names), schema=selected, **kwargs)

    def compute(self, inputs: TabularData, training: bool = False, pad_mask=None,
                generator=None) -> TabularData:
        return {
            name: inputs[name].float()[..., None]
            for name in self.features
            if name in inputs
        }

    def feature_sizes(self) -> Dict[str, int]:
        return {name: 1 for name in self.features}
