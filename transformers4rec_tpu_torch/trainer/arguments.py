"""Training arguments.

Counterpart of ``transformers4rec_tpu/trainer/arguments.py``: the same field
names, with the same defaults but for ``checkpoint_format``. It takes
``"torch"`` (the default: one gathered ``torch.save`` file, the JAX
package's ``"msgpack"``) and ``"sharded"`` (each rank writes the rows it
holds, the JAX package's ``"orbax"``); the JAX names raise a ``ValueError``
naming their counterpart. ``save_async`` writes checkpoints on a thread,
and ``profile_steps="lo,hi"`` traces those steps of ``train()`` into
``profile_dir`` (default ``output_dir/profile``).

``mesh_model_axis`` is the model axis of the trainer's ('data', 'model')
layout of ranks (``parallel.mesh``), and ``auto_vocab_parallel`` row-shards
the tied item table over it. As in the JAX package the batch sizes are per
device: ``train_batch_size`` is ``per_device_train_batch_size`` times the
ranks of the world, and each data row of the layout loads
``train_batch_size // data`` rows of it.

``embedding_optimizer`` takes the reference's five arms: ``"adafactor"``,
``"dense"``, ``"lazy_adam"`` (``ops.sparse_update.LazyAdam`` on every
table) and the sparse arms ``"sparse_adam"`` and ``"sparse_adafactor"``
(``trainer.sparse_embedding_step``). As in the reference, bf16 moments or
tables on ``"dense"`` or ``"lazy_adam"`` warn and stay float32.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch.distributed as dist

# embedding_optimizer values that route the item table through the sparse
# step (trainer/sparse_embedding_step.py)
SPARSE_OPTIMIZERS = ("sparse_adam", "sparse_adafactor")


@dataclasses.dataclass
class T4RecTrainingArguments:
    output_dir: str = "./t4rec_output"

    max_sequence_length: Optional[int] = None
    # "parquet" (and its alias "merlin"), "parquet_streaming" or "synthetic"
    data_loader_engine: str = "parquet"
    # batches of evaluate(on_train_set=True)
    eval_steps_on_train_set: int = 20
    predict_top_k: int = 100
    # evaluate() also writes its top-k predictions (log_predictions())
    log_predictions: bool = False
    # update the ranking metrics on every n-th evaluation batch (the loss on all)
    compute_metrics_each_n_steps: int = 1
    learning_rate_num_cosine_cycles_by_epoch: float = 1.25
    # fit_and_evaluate scores {t}/test.parquet instead of valid.parquet
    eval_on_test_set: bool = False
    # shuffle-buffer rows of the streaming engine (0: its default)
    shuffle_buffer_size: int = 0
    # label written into each metrics.jsonl record
    experiments_group: str = "default"
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
    # everywhere; "lazy_adam" moves only the rows with a gradient;
    # "sparse_adam" / "sparse_adafactor" update the item table's touched rows
    # in O(N·E) (trainer/sparse_embedding_step.py)
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
    # session packing (data/packing.py): the training loader packs several
    # short sessions a row, with a block-diagonal attention restriction
    pack_sessions: bool = False
    # pack the evaluation loader too: one target per segment (its last
    # item), so the metrics equal unpacked evaluation's; predict() and
    # log_predictions stay unpacked
    pack_eval_sessions: bool = False
    seed: int = 42
    # read by no module, as in the JAX arguments: rematerialisation is the
    # encoder's, TransformerConfig's remat=True (e.g. XLNetConfig.build(...,
    # remat=True))
    gradient_checkpointing: bool = False

    # logging / eval / checkpointing
    checkpoint_format: str = "torch"
    save_async: bool = False
    logging_steps: int = 100
    eval_steps: Optional[int] = None
    save_steps: Optional[int] = None
    # older checkpoints are removed beyond this many; the best one stays
    save_total_limit: Optional[int] = None
    # train() ends by restoring the weights of the checkpoint whose
    # evaluation scored best on metric_for_best_model ("eval_" is added when
    # absent; a bare name such as "recall_at_10" resolves to the one task key
    # that ends in it); greater_is_better None means False for a loss
    load_best_model_at_end: bool = False
    metric_for_best_model: Optional[str] = None
    greater_is_better: Optional[bool] = None
    # "tensorboard" writes scalars under {output_dir}/runs
    report_to: str = "none"
    disable_tqdm: bool = True
    profile_steps: Optional[str] = None
    profile_dir: Optional[str] = None
    # append train and evaluation metrics to {output_dir}/metrics.jsonl
    log_json: bool = False

    mesh_model_axis: int = 1
    # storage dtype of the table optimizer's moments ("adafactor" and the
    # sparse arms): "bf16" (default) halves the optimizer state; None / "f32"
    # keeps float32
    embedding_moment_dtype: Optional[str] = "bf16"
    # storage dtype of the tables themselves: "bf16" stores every 2-D table
    # (``trainer.table_param_names``) as bfloat16 on the adafactor and sparse
    # arms (products accumulate in f32, optimizer arithmetic is f32, each
    # update rounds to bf16 on store); None / "f32" keeps float32
    embedding_table_dtype: Optional[str] = None
    auto_vocab_parallel: bool = True

    def __post_init__(self):
        if self.embedding_moment_dtype not in (None, "f32", "bf16"):
            # a typo ('bfloat16') must not silently select the f32 arm
            raise ValueError("embedding_moment_dtype must be None, 'f32', or 'bf16' "
                             f"(got {self.embedding_moment_dtype!r})")
        if self.embedding_table_dtype not in (None, "f32", "bf16"):
            raise ValueError("embedding_table_dtype must be None, 'f32', or 'bf16' "
                             f"(got {self.embedding_table_dtype!r})")
        if self.embedding_optimizer not in ("adafactor", "dense", "lazy_adam") + SPARSE_OPTIMIZERS:
            raise ValueError(f"unknown embedding_optimizer {self.embedding_optimizer!r}")
        dense_arm = self.embedding_optimizer in ("dense", "lazy_adam")
        if self.embedding_table_dtype == "bf16" and dense_arm:
            warnings.warn(
                "embedding_table_dtype='bf16' is validated for the adafactor/sparse table "
                f"arms; embedding_optimizer={self.embedding_optimizer!r} keeps f32 tables")
            self.embedding_table_dtype = None
        if self.embedding_moment_dtype == "bf16" and dense_arm:
            warnings.warn(
                "embedding_moment_dtype='bf16' applies to the adafactor table arm only; "
                f"embedding_optimizer={self.embedding_optimizer!r} keeps f32 moments")
        if self.data_loader_engine not in ("parquet", "merlin", "parquet_streaming",
                                           "synthetic"):
            raise ValueError(f"unknown data_loader_engine {self.data_loader_engine!r}")
        if self.mesh_model_axis < 1:
            raise ValueError(f"mesh_model_axis must be at least 1 (got {self.mesh_model_axis})")
        if self.checkpoint_format in CHECKPOINT_COUNTERPARTS:
            raise ValueError(
                f"checkpoint_format={self.checkpoint_format!r} is the JAX package's; the "
                f"port's counterpart is {CHECKPOINT_COUNTERPARTS[self.checkpoint_format]!r}")
        if self.checkpoint_format not in CHECKPOINT_FORMATS:
            raise ValueError(f"unknown checkpoint_format {self.checkpoint_format!r}; "
                             f"known: {CHECKPOINT_FORMATS}")
        if self.profile_steps is not None:
            try:
                lo, hi = (int(x) for x in self.profile_steps.split(","))
            except ValueError:
                raise ValueError(f"profile_steps must be 'start,stop', got "
                                 f"{self.profile_steps!r}") from None
            if not 0 <= lo < hi:
                raise ValueError(f"profile_steps needs 0 <= start < stop, got {lo}, {hi}")

    @property
    def train_batch_size(self) -> int:
        """The global batch: per device times the ranks of the world."""
        return self.per_device_train_batch_size * _world_size()

    @property
    def eval_batch_size(self) -> int:
        return self.per_device_eval_batch_size * _world_size()


CHECKPOINT_FORMATS = ("torch", "sharded")
# the JAX package's formats and the port's counterparts
CHECKPOINT_COUNTERPARTS = {"msgpack": "torch", "orbax": "sharded"}


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
