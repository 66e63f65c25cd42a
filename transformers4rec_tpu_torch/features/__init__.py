from .continuous import ContinuousFeatures
from .embedding import (
    EmbeddingFeatures,
    FeatureConfig,
    PretrainedEmbeddingFeatures,
    PretrainedEmbeddingsInitializer,
    SequenceEmbeddingFeatures,
    SoftEmbedding,
    SoftEmbeddingFeatures,
    TableConfig,
)
from .sequence import TabularSequenceFeatures
from .tabular import TabularFeatures

__all__ = [
    "ContinuousFeatures",
    "EmbeddingFeatures",
    "FeatureConfig",
    "PretrainedEmbeddingFeatures",
    "PretrainedEmbeddingsInitializer",
    "SequenceEmbeddingFeatures",
    "SoftEmbedding",
    "SoftEmbeddingFeatures",
    "TableConfig",
    "TabularFeatures",
    "TabularSequenceFeatures",
]
