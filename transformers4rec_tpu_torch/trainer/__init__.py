from .arguments import T4RecTrainingArguments
from .schedulers import get_scheduler, num_cosine_cycles
from .trainer import Trainer, TrainerState, clip_by_global_norm_

__all__ = [
    "T4RecTrainingArguments",
    "Trainer",
    "TrainerState",
    "clip_by_global_norm_",
    "get_scheduler",
    "num_cosine_cycles",
]
