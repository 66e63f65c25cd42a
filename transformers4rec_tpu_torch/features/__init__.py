from .continuous import ContinuousFeatures
from .embedding import (
    EmbeddingFeatures,
    FeatureConfig,
    SequenceEmbeddingFeatures,
    TableConfig,
)
from .sequence import TabularSequenceFeatures
from .tabular import TabularFeatures

__all__ = [
    "ContinuousFeatures",
    "EmbeddingFeatures",
    "FeatureConfig",
    "SequenceEmbeddingFeatures",
    "TableConfig",
    "TabularFeatures",
    "TabularSequenceFeatures",
]
