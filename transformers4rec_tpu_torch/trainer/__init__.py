from .arguments import SPARSE_OPTIMIZERS, T4RecTrainingArguments
from .schedulers import get_scheduler, num_cosine_cycles
from .sparse_embedding_step import (
    SparseAccumState,
    SparseEmbeddingStep,
    sparse_accum_init,
    validate_sparse_config,
)
from .trainer import (
    Trainer,
    TrainerState,
    cast_tables_,
    clip_by_global_norm_,
    table_param_names,
)

__all__ = [
    "SPARSE_OPTIMIZERS",
    "SparseAccumState",
    "SparseEmbeddingStep",
    "T4RecTrainingArguments",
    "Trainer",
    "TrainerState",
    "cast_tables_",
    "clip_by_global_norm_",
    "get_scheduler",
    "num_cosine_cycles",
    "sparse_accum_init",
    "table_param_names",
    "validate_sparse_config",
]
