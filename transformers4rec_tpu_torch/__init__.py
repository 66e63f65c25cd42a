"""transformers4rec_tpu_torch — the PyTorch / CUDA port of transformers4rec_tpu.

A second package beside the JAX one, which stays the reference. It carries
the training, evaluation and inference paths of the REES46 XLNet-MLM model:
schema-driven input modules, MLM masking, the unified transformer encoder,
next-item prediction over a tied item table, the ``Trainer`` with AdamW on
the dense weights and Adafactor on the embedding tables, streaming ranking
metrics and the dynamic-batching HTTP server. Every pass over the whole
vocabulary is a hand-written CUDA kernel (``ops/vocab.py``): the training
cross-entropy forward and backward (``csrc/ce_fwd.cu``, ``csrc/ce_bwd.cu``)
and the evaluation's loss-and-rank pass (``csrc/ce_rank.cu``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"

from . import (
    blocks, config, convert, data, features, masking, model, ops, schema, serving, tabular,
    trainer, utils,
)
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
from .trainer import T4RecTrainingArguments, Trainer

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
    "T4RecTrainingArguments",
    "TabularFeatures",
    "TabularSequenceFeatures",
    "Tags",
    "Trainer",
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
    "trainer",
    "transformer_registry",
    "utils",
    "__version__",
]
