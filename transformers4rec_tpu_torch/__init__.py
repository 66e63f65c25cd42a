"""transformers4rec_tpu_torch — the PyTorch / CUDA port of transformers4rec_tpu.

A second package beside the JAX one, which stays the reference. This slice
carries the inference and evaluation path of the REES46 XLNet-MLM model:
schema-driven input modules, MLM masking (inference and testing branches),
the unified transformer encoder, next-item prediction over a tied item
table, streaming ranking metrics and the dynamic-batching HTTP server.
Evaluation scores every row against the whole vocabulary in one pass with
a hand-written CUDA kernel (``ops/vocab.py``, ``csrc/ce_rank.cu``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import blocks, config, convert, data, features, masking, model, ops, schema, serving, tabular, utils
from .blocks import SequentialBlock, TransformerBlock, TransformerEncoder
from .config import T4RecConfig, XLNetConfig, transformer_registry
from .features import (
    ContinuousFeatures,
    EmbeddingFeatures,
    SequenceEmbeddingFeatures,
    TabularFeatures,
    TabularSequenceFeatures,
)
from .masking import MaskingInfo, masking_registry
from .model import Head, Model, NextItemPredictionTask, ranking_metric
from .schema import ColumnSchema, Schema, Tags

__all__ = [
    "ColumnSchema",
    "ContinuousFeatures",
    "EmbeddingFeatures",
    "Head",
    "MaskingInfo",
    "Model",
    "NextItemPredictionTask",
    "Schema",
    "SequenceEmbeddingFeatures",
    "SequentialBlock",
    "T4RecConfig",
    "TabularFeatures",
    "TabularSequenceFeatures",
    "Tags",
    "TransformerBlock",
    "TransformerEncoder",
    "XLNetConfig",
    "blocks",
    "config",
    "convert",
    "data",
    "features",
    "masking",
    "masking_registry",
    "model",
    "ops",
    "ranking_metric",
    "schema",
    "serving",
    "tabular",
    "transformer_registry",
    "utils",
    "__version__",
]
