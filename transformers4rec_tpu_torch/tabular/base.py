"""Tabular core: the dict-of-tensors ("TabularData") compute model.

Counterpart of ``transformers4rec_tpu/tabular/base.py``. Blocks are
``nn.Module``s that take and return ``{name: tensor}``; aggregations are
stateless callables turning the dict into one tensor. ``output_size`` is
analytic from the schema, as in the JAX package.

Not ported yet (raise ``NotImplementedError``): ``pre``/``post``
transformations and ``merge_with``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..schema import Schema
from ..utils.registry import Registry

TabularData = Dict[str, torch.Tensor]

tabular_aggregation_registry: Registry = Registry("tabular_aggregation")


class TabularAggregation:
    """Stateless dict→tensor reduction. Subclasses registered by name."""

    def __call__(self, inputs: TabularData) -> torch.Tensor:
        raise NotImplementedError

    def output_size(self, input_sizes: Dict[str, int]) -> int:
        """Final feature dim given per-feature dims."""
        raise NotImplementedError

    @staticmethod
    def _expand_non_sequential(inputs: TabularData) -> TabularData:
        """Broadcast (B, D) features to (B, S, D) when mixed with sequential ones."""
        ndims = {v.dim() for v in inputs.values()}
        if ndims == {2, 3}:
            seq_len = next(v.shape[1] for v in inputs.values() if v.dim() == 3)
            return {
                k: (v[:, None, :].expand(v.shape[0], seq_len, v.shape[1])
                    if v.dim() == 2 else v)
                for k, v in inputs.items()
            }
        return inputs


def parse_aggregation(agg, schema: Optional[Schema] = None) -> Optional[TabularAggregation]:
    if agg is None or isinstance(agg, TabularAggregation):
        return agg
    cls = tabular_aggregation_registry.parse(agg)
    try:
        return cls(schema=schema)
    except TypeError:
        return cls()


class TabularBlock(nn.Module):
    """Base for blocks taking and producing TabularData, with the
    compute → aggregation pipeline.

    Subclasses implement ``compute(inputs) -> TabularData`` and
    ``feature_sizes() -> Dict[str, int]`` (per-feature output dims).
    """

    def __init__(self, pre=None, post=None, aggregation=None,
                 schema: Optional[Schema] = None):
        super().__init__()
        if pre is not None or post is not None:
            raise NotImplementedError(
                "pre/post tabular transformations are not ported yet"
            )
        self.aggregation = aggregation
        self.schema = schema

    def compute(self, inputs: TabularData) -> TabularData:
        return inputs

    def feature_sizes(self) -> Dict[str, int]:
        raise NotImplementedError

    def output_size(self) -> int:
        """Aggregated feature dim (analytic)."""
        sizes = self.feature_sizes()
        agg = parse_aggregation(self.aggregation, self.schema)
        if agg is None:
            return sum(sizes.values())
        return agg.output_size(sizes)

    def forward(self, inputs: TabularData, training: bool = False, aggregation=None):
        outputs = self.compute(inputs)
        agg = parse_aggregation(aggregation or self.aggregation, self.schema)
        if agg is not None:
            return agg(outputs)
        return outputs

