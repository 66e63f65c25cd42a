from .schema import (
    ColumnSchema,
    FeatureType,
    FixedShape,
    FloatDomain,
    IntDomain,
    Schema,
    ValueCount,
    get_embedding_size_from_cardinality,
    requires_schema,
)
from .tags import Tags

__all__ = [
    "ColumnSchema",
    "FeatureType",
    "FixedShape",
    "FloatDomain",
    "IntDomain",
    "Schema",
    "Tags",
    "ValueCount",
    "get_embedding_size_from_cardinality",
    "requires_schema",
]
