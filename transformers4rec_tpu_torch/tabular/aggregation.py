"""Feature aggregations: dict-of-tensors → tensor.

Counterpart of ``transformers4rec_tpu/tabular/aggregation.py``: ``concat``
and ``stack`` in sorted-key order, ``element-wise-sum`` and
``element-wise-sum-item-multi`` (the item embedding times the sum of the
others, which needs the schema for the item-id column).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..schema import Schema
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


def _one_size(what: str, input_sizes: Dict[str, int]) -> int:
    sizes = set(input_sizes.values())
    if len(sizes) != 1:
        raise ValueError(f"{what} requires equal dims, got {input_sizes}")
    return next(iter(sizes))


@tabular_aggregation_registry.register("stack")
class StackFeatures(TabularAggregation):
    """Stack along a new axis (features must share dims), sorted-key order."""

    def __init__(self, axis: int = -1, schema=None):
        self.axis = axis

    def __call__(self, inputs: TabularData) -> torch.Tensor:
        inputs = self._expand_non_sequential(inputs)
        return torch.stack([inputs[k] for k in sorted(inputs)], dim=self.axis)

    def output_size(self, input_sizes: Dict[str, int]) -> int:
        size = _one_size("stack", input_sizes)
        # at the last axis the features form a new trailing dim: its size is
        # their count
        return len(input_sizes) if self.axis in (-1, None) else size


def _check_equal_dims(inputs: TabularData) -> None:
    shapes = {k: v.shape[-1] for k, v in inputs.items()}
    if len(set(shapes.values())) > 1:
        raise ValueError(f"Elementwise aggregation requires equal last dims, got {shapes}. "
                         "Hint: pass matching embedding dims or a continuous projection.")


@tabular_aggregation_registry.register("element-wise-sum", "elementwise-sum", "sum")
class ElementwiseSum(TabularAggregation):
    def __init__(self, schema=None):
        pass

    def __call__(self, inputs: TabularData) -> torch.Tensor:
        inputs = self._expand_non_sequential(inputs)
        _check_equal_dims(inputs)
        return sum(inputs.values())

    def output_size(self, input_sizes: Dict[str, int]) -> int:
        return _one_size("element-wise-sum", input_sizes)


@tabular_aggregation_registry.register("element-wise-sum-item-multi",
                                       "elementwise-sum-item-multi")
class ElementwiseSumItemMulti(TabularAggregation):
    """``item_embedding * sum(other feature embeddings)``."""

    def __init__(self, schema: Optional[Schema] = None):
        if schema is None:
            raise ValueError("element-wise-sum-item-multi requires a schema")
        self.item_col = schema.item_id_column_name

    def __call__(self, inputs: TabularData) -> torch.Tensor:
        inputs = self._expand_non_sequential(inputs)
        _check_equal_dims(inputs)
        others = [v for k, v in inputs.items() if k != self.item_col]
        if not others:
            raise ValueError("element-wise-sum-item-multi needs at least one non-item feature")
        return inputs[self.item_col] * sum(others)

    def output_size(self, input_sizes: Dict[str, int]) -> int:
        return _one_size("element-wise-sum-item-multi", input_sizes)
