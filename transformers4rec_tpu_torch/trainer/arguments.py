"""Training arguments.

Counterpart of ``transformers4rec_tpu/trainer/arguments.py``: the fields the
dense single-device training path reads, under the same names and with the
same defaults. Options whose code is not ported yet raise
``NotImplementedError`` when the arguments are built: the sparse and lazy
table optimizers, bf16-stored tables and gradient accumulation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

SPARSE_OPTIMIZERS = ("sparse_adam", "sparse_adafactor")


@dataclasses.dataclass
class T4RecTrainingArguments:
    output_dir: str = "./t4rec_output"

    max_sequence_length: Optional[int] = None
    learning_rate_num_cosine_cycles_by_epoch: float = 1.25
    # applies to the TRAIN loader only; False keeps a final zero-filled batch
    # whose fill rows carry no loss or metric weight
    dataloader_drop_last: bool = False

    # optimization
    learning_rate: float = 5e-4
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    # table optimizer: "adafactor" routes every embedding table through the
    # unfactored FusedAdafactor (ops/fused_adafactor.py); "dense" is AdamW
    # everywhere
    embedding_optimizer: str = "adafactor"
    lr_scheduler_type: str = "linear"
    warmup_steps: int = 0
    num_train_epochs: float = 1.0
    max_steps: int = -1
    per_device_train_batch_size: int = 64
    per_device_eval_batch_size: int = 32
    gradient_accumulation_steps: int = 1
    # K optimizer steps are enqueued on the device between host reads of the
    # loss (no synchronisation inside a group); the trajectory equals K = 1
    # bit for bit
    steps_per_execution: int = 8
    seed: int = 42

    # logging / eval / checkpointing
    logging_steps: int = 100
    eval_steps: Optional[int] = None
    save_steps: Optional[int] = None

    # storage dtype of the table optimizer's second moment ("adafactor" only):
    # "bf16" (default) halves the optimizer state; None / "f32" keeps float32
    embedding_moment_dtype: Optional[str] = "bf16"
    # storage dtype of the tables themselves; only float32 is ported
    embedding_table_dtype: Optional[str] = None

    def __post_init__(self):
        if self.embedding_moment_dtype not in (None, "f32", "bf16"):
            # a typo ('bfloat16') must not silently select the f32 arm
            raise ValueError("embedding_moment_dtype must be None, 'f32', or 'bf16' "
                             f"(got {self.embedding_moment_dtype!r})")
        if self.embedding_table_dtype not in (None, "f32", "bf16"):
            raise ValueError("embedding_table_dtype must be None, 'f32', or 'bf16' "
                             f"(got {self.embedding_table_dtype!r})")
        if self.embedding_optimizer in SPARSE_OPTIMIZERS + ("lazy_adam",):
            raise NotImplementedError(
                f"embedding_optimizer={self.embedding_optimizer!r} is not ported yet"
            )
        if self.embedding_optimizer not in ("adafactor", "dense"):
            raise ValueError(f"unknown embedding_optimizer {self.embedding_optimizer!r}")
        if self.embedding_table_dtype == "bf16":
            raise NotImplementedError("bf16-stored tables are not ported yet")
        if self.gradient_accumulation_steps > 1:
            raise NotImplementedError("gradient accumulation is not ported yet")

    @property
    def train_batch_size(self) -> int:
        return self.per_device_train_batch_size

    @property
    def eval_batch_size(self) -> int:
        return self.per_device_eval_batch_size

