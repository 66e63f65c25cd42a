from .aggregation import ConcatFeatures
from .base import (
    TabularAggregation,
    TabularBlock,
    TabularData,
    parse_aggregation,
    tabular_aggregation_registry,
)

__all__ = [
    "ConcatFeatures",
    "TabularAggregation",
    "TabularBlock",
    "TabularData",
    "parse_aggregation",
    "tabular_aggregation_registry",
]
