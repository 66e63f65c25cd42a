"""Feature aggregations: dict-of-tensors → tensor.

Counterpart of ``transformers4rec_tpu/tabular/aggregation.py``
(``ConcatFeatures``: concatenation in sorted-key order).
"""

from __future__ import annotations

from typing import Dict

import torch

from .base import TabularAggregation, TabularData, tabular_aggregation_registry


@tabular_aggregation_registry.register("concat")
class ConcatFeatures(TabularAggregation):
    """Concatenate along the last axis, sorted-key order."""

    def __init__(self, axis: int = -1, schema=None):
        self.axis = axis

    def __call__(self, inputs: TabularData) -> torch.Tensor:
        inputs = self._expand_non_sequential(inputs)
        return torch.cat([inputs[k] for k in sorted(inputs)], dim=self.axis)

    def output_size(self, input_sizes: Dict[str, int]) -> int:
        return sum(input_sizes.values())
