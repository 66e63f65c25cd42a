"""transformers4rec_tpu_torch — the PyTorch / CUDA port of transformers4rec_tpu.

A second package beside the JAX one, which stays the reference. It carries
the training, evaluation and inference paths of the REES46 XLNet-MLM model,
of GPT-2 with causal language modelling on long sessions, of XLNet-PLM and
of the BERT family (BERT, RoBERTa, ELECTRA with RTD masking, ALBERT,
Longformer), TransfoXL, Reformer (local and LSH attention layers, axial
positions) and recurrent GRU/LSTM bodies (``RNNBlock``), with session
packing in training and evaluation: schema-driven input modules, MLM, CLM, PLM and
RTD masking, the unified transformer encoder,
next-item prediction over a tied item table or an untied output layer,
with full or log-uniform sampled softmax, binary and regression tasks in
multi-task heads, the ``Trainer`` with AdamW on
the dense weights and Adafactor (or lazy Adam) on the embedding tables, the
O(N·E) sparse step for million-item tables (``sparse_adam``,
``sparse_adafactor``: only the rows a step touches move) and gradient
accumulation, streaming ranking
metrics and the dynamic-batching HTTP server. Every pass over the whole
vocabulary is a hand-written CUDA kernel (``ops/vocab.py``): the training
cross-entropy forward and backward (``csrc/ce_fwd.cu``, ``csrc/ce_bwd.cu``)
and the evaluation's loss-and-rank pass (``csrc/ce_rank.cu``). From sessions
of 128 on, attention runs through the flash kernels of ``ops/attention.py``
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``). The input options of the
paper's command line (swap noise, per-feature LayerNorm, side features,
``MLPBlock``) and its experiment script (``paper_repro.transf_exp_main``)
are ported too, and so are ``experimental.PostContextFusion`` and the four
scripts of ``examples/`` (``python -m
transformers4rec_tpu_torch.examples.<name>``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"

from . import (
    blocks, config, convert, data, experimental, features, masking, model, ops, schema,
    serving, tabular, trainer, utils,
)
from .blocks import (
    Block,
    MLPBlock,
    RNNBlock,
    SequentialBlock,
    TransformerBlock,
    TransformerEncoder,
)
from .config import (
    AlbertConfig,
    BertConfig,
    ElectraConfig,
    GPT2Config,
    LongformerConfig,
    ReformerConfig,
    RobertaConfig,
    T4RecConfig,
    TransfoXLConfig,
    XLNetConfig,
    transformer_registry,
)
from .features import (
    ContinuousFeatures,
    EmbeddingFeatures,
    PretrainedEmbeddingFeatures,
    SequenceEmbeddingFeatures,
    SoftEmbeddingFeatures,
    TabularFeatures,
    TabularSequenceFeatures,
)
from .masking import MaskingInfo, masking_registry
from .ops.sparse_update import (
    LazyAdam,
    dedupe_row_grads,
    sharded_rows_adam_update,
    sparse_rows_adafactor_init,
    sparse_rows_adafactor_update,
    sparse_rows_adam_init,
    sparse_rows_adam_update,
)
from .model import (
    BinaryClassificationTask,
    Head,
    Model,
    NextItemPredictionTask,
    PredictionTask,
    RegressionTask,
    ranking_metric,
)
from .schema import ColumnSchema, Schema, Tags
from .tabular import MergeTabular, StochasticSwapNoise, TabularDropout, TabularLayerNorm
from .trainer import SPARSE_OPTIMIZERS, T4RecTrainingArguments, Trainer

__all__ = [
    "AlbertConfig",
    "BertConfig",
    "BinaryClassificationTask",
    "Block",
    "ColumnSchema",
    "ContinuousFeatures",
    "ElectraConfig",
    "LazyAdam",
    "EmbeddingFeatures",
    "GPT2Config",
    "Head",
    "LongformerConfig",
    "MLPBlock",
    "MaskingInfo",
    "MergeTabular",
    "Model",
    "NextItemPredictionTask",
    "PredictionTask",
    "PretrainedEmbeddingFeatures",
    "RNNBlock",
    "ReformerConfig",
    "RegressionTask",
    "RobertaConfig",
    "SPARSE_OPTIMIZERS",
    "Schema",
    "SequenceEmbeddingFeatures",
    "SequentialBlock",
    "SoftEmbeddingFeatures",
    "StochasticSwapNoise",
    "T4RecConfig",
    "T4RecTrainingArguments",
    "TabularDropout",
    "TabularFeatures",
    "TabularLayerNorm",
    "TabularSequenceFeatures",
    "Tags",
    "TransfoXLConfig",
    "Trainer",
    "TransformerBlock",
    "TransformerEncoder",
    "XLNetConfig",
    "blocks",
    "config",
    "convert",
    "data",
    "dedupe_row_grads",
    "experimental",
    "features",
    "masking",
    "masking_registry",
    "model",
    "ops",
    "ranking_metric",
    "schema",
    "serving",
    "sharded_rows_adam_update",
    "sparse_rows_adafactor_init",
    "sparse_rows_adafactor_update",
    "sparse_rows_adam_init",
    "sparse_rows_adam_update",
    "tabular",
    "trainer",
    "transformer_registry",
    "utils",
    "__version__",
]
