from .arguments import SPARSE_OPTIMIZERS, T4RecTrainingArguments
from .schedulers import get_scheduler, num_cosine_cycles
from .sparse_embedding_step import (
    SparseAccumState,
    SparseEmbeddingStep,
    sparse_accum_init,
    validate_sparse_config,
)
from .trainer import Trainer, TrainerState, clip_by_global_norm_

__all__ = [
    "SPARSE_OPTIMIZERS",
    "SparseAccumState",
    "SparseEmbeddingStep",
    "T4RecTrainingArguments",
    "Trainer",
    "TrainerState",
    "clip_by_global_norm_",
    "get_scheduler",
    "num_cosine_cycles",
    "sparse_accum_init",
    "validate_sparse_config",
]
