"""Trainer: optimizer wiring and the training loop.

Counterpart of ``transformers4rec_tpu/trainer/trainer.py`` on its dense,
single-device path. The optimizers reproduce the reference's optax chain:

- a global-norm clip over all gradients, tables included, in optax's form
  (unchanged below ``max_grad_norm``, else ``g / norm * max_grad_norm``;
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and differs);
- dense parameters: ``torch.optim.AdamW`` (eps outside the root, decoupled
  decay: ``optax.adamw``), with ``weight_decay`` passed explicitly;
- embedding tables (``ops.sparse_update.label_embedding_params``):
  ``FusedAdafactor`` with the same schedule, AdamW too with
  ``embedding_optimizer="dense"``, ``LazyAdam`` with ``"lazy_adam"``, or
  what ``table_optimizer(tables, schedule)`` returns when the caller gives
  one (``flagship.build_trainer`` hands in the streamed table update that
  way);
- ``"sparse_adam"`` / ``"sparse_adafactor"``: the item table leaves both
  optimizers for ``sparse_embedding_step.SparseEmbeddingStep``, which
  gathers its touched rows outside autograd and updates only those (the
  clip then covers the dense gradients and the rows' jointly); the other
  tables keep ``FusedAdafactor``.

``gradient_accumulation_steps = K`` (``optax.MultiSteps`` semantics): the
gradients of K micro-steps sum in ``.grad`` (the sparse arm also keeps each
micro-step's rows), and the K-th divides them by K, clips that mean and
makes one update; in between no parameter moves. ``global_step`` and
``max_steps`` count micro-steps, the schedule counts updates.

``steps_per_execution = K``: K optimizer steps are enqueued on the device
between host reads of the loss, and the K batches are copied to the device
before the first of them, so nothing synchronises inside a group. A group
never crosses the run's end, an evaluation or a save boundary, losses are
read after the group that holds a logging step, and the trajectory equals
K = 1 bit for bit. All random draws of a step (the
mask, then dropout) come from one ``torch.Generator`` on the model's device,
seeded from ``args.seed`` and saved with a checkpoint.

Data: a path (a Parquet file, a directory of them, a list, a
``ParquetDataset``) is read by the loader ``args.data_loader_engine`` names
(``data.loader.dataloader_registry``: ``"parquet"``, its alias ``"merlin"``,
``"parquet_streaming"``, ``"synthetic"``); a dict of numpy columns is held in
memory. Under ``"synthetic"`` the sessions are synthesized from the schema;
under any other engine, training, evaluation and prediction without their
dataset raise, and periodic evaluation runs only with evaluation data, as
in the JAX package.
``dataloader_drop_last`` applies to the training loader only: evaluation
and prediction keep the zero-filled tail, so every session counts once and
``predict`` returns one row per session. ``pack_sessions`` packs the
training loader's sessions several to a row (``data.packing``),
``pack_eval_sessions`` the evaluation loader's; ``predict`` and
``log_predictions`` stay unpacked.

``embedding_table_dtype="bf16"`` casts every 2-D table
(``table_param_names``: the categorical tables ``...tables.<feature>`` and a
soft embedding's ``embedding_table``, the parameters whose flax names end in
``_table``) to bfloat16 when the trainer is made, before any optimizer
state exists, as the JAX trainer casts after its init. The kernels then
read the bf16 table, the table optimizers keep their arithmetic in f32 and
round each update to bf16 on store, and checkpoints keep the tables bf16
(``load`` gives each parameter the type the checkpoint stored it in).

``save`` / ``load`` write one ``torch.save`` file with the model, both
optimizers, the generator and the loader position; ``train(resume_from_
checkpoint=path)`` finishes an interrupted ``max_steps`` run exactly, from
the middle of an epoch too. ``save_total_limit`` rotates the checkpoints,
never the best one, and ``load_best_model_at_end`` restores the best
weights. ``log_json`` appends metrics to ``metrics.jsonl``, ``report_to=
"tensorboard"`` writes them under ``runs/``. ``predict`` and
``log_predictions`` give the top-k; ``reset_model``, ``reset_lr_scheduler``
and ``wipe_memory`` serve ``utils.examples_utils.fit_and_evaluate``, the
time-window protocol.

**Ranks** (``parallel.mesh``). The trainer runs over a ('data', 'model')
layout of ``torch.distributed`` ranks: ``mesh=``, else
``make_mesh(model=args.mesh_model_axis)`` over the initialised world (one
rank without a world). Every rank builds the same model and makes its own
trainer; the replicas then start from rank 0's weights (a row shard from
its data row 0 peer's), as DDP broadcasts them.

- 'data': each data row's loader loads its stripe of the global batch
  (``args.train_batch_size // data`` rows), every task's loss is the global
  weighted mean (``mesh.data_parallel_loss``), and the gradients are summed
  over the data group once per update, after the K-th micro-step.
- 'model': with ``auto_vocab_parallel`` a tied item table that the sharding
  rule takes (``mesh.shards_rows``) is replaced by this rank's rows and its
  task gets the model group (``_maybe_auto_vocab_parallel``); other
  categorical tables the rule takes are row-sharded for their lookups. The
  tables' optimizer state lives on the shards (Adafactor's moment, the
  sparse arms' and ``lazy_adam``'s per-row moments), and the clip counts
  each shard once: the shards' squares are summed over the model group.
- draws: each data row's generator is seeded from ``args.seed`` and its
  data index (``DATA_SEED_STRIDE``), so the ranks of a row draw the same
  masks, dropout, swap noise and negatives, and the rows draw apart; data
  index 0 draws as a trainer without ranks does.
- ``evaluate`` sums its metric and loss states over the data group once;
  ``predict`` gathers the data rows' top-k in the dataset's order.
- a ``"torch"`` checkpoint gathers the shards to rank 0, which writes the
  one file of the one-rank format (and every data row's generator); a
  ``"sharded"`` one is written by every rank of data row 0, each its own
  rows (``trainer/checkpoint.py``). Loading either takes this rank's rows,
  so a checkpoint loads on any layout. Logging, ``metrics.jsonl``,
  TensorBoard, progress bars and the checkpoints' rotation are rank 0's.
- a save part-way through gradient accumulation keeps the pending
  gradients summed over the data group; on load data row 0 takes them.

``save_async`` writes checkpoints on a thread after a host snapshot, and
``profile_steps="lo,hi"`` records steps ``lo`` to ``hi`` of ``train()`` with
``torch.profiler`` (CPU and CUDA activity, one step a group while the window
is open) into ``profile_dir`` (default ``output_dir/profile``), as a Chrome
trace per rank.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed

from ..data.loader import InMemoryDataLoader, dataloader_registry
from ..data.packing import pack_sessions
from ..masking import MaskingInfo
from ..model.base import Model, load_weights, task_loss_coefficients
from ..model.prediction_task import NextItemPredictionTask
from ..ops.fused_adafactor import FusedAdafactor
from ..ops.sparse_update import LazyAdam, label_embedding_params
from ..parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_,
    all_reduce_grads_,
    barrier,
    broadcast_replicas_,
    data_parallel_loss,
    interleave_stripes,
    make_mesh,
    process_data_stripe,
    shards_rows,
    take_shard,
)
from ..schema import Schema
from ..utils.device import resolve_device
from .arguments import SPARSE_OPTIMIZERS, T4RecTrainingArguments
from .checkpoint import (
    CHECKPOINT_FILE,
    RowShard,
    RowShards,
    ShardReader,
    checkpoint_complete,
    replicated_file,
    rows_file,
    sharded_shards,
    snapshot,
    wait_all_pending,
    write_files,
)
from .schedulers import get_scheduler, num_cosine_cycles
from .sparse_embedding_step import SparseEmbeddingStep, validate_sparse_config
# tied item tables from this many rows on hear of the sparse arms once
SPARSE_HINT_MIN_ROWS = 1_000_000
# data row i's generator is seeded args.seed + 17 + DATA_SEED_STRIDE * i
DATA_SEED_STRIDE = 1_000_003


@dataclasses.dataclass
class TrainerState:
    """Host-side bookkeeping: ``global_step`` stays monotonic across
    ``train()`` calls; (loader_epoch, batches_in_epoch) pins the next batch
    for a mid-epoch resume."""

    global_step: int = 0
    past_global_steps: int = 0
    epoch: float = 0.0
    log_history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    loader_epoch: int = 0
    batches_in_epoch: int = 0


def table_param_names(model: torch.nn.Module) -> List[str]:
    """The parameters ``embedding_table_dtype="bf16"`` stores as bfloat16:
    every 2-D one whose flax name ends in ``_table`` (the JAX trainer's rule),
    which in the port are the categorical tables (``...tables.<feature>``)
    and a soft embedding's ``embedding_table``. An untied ``output_layer``,
    positions and the masked embedding stay f32."""
    names = []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if p.dim() == 2 and (parts[-1].endswith("_table")
                             or (len(parts) > 1 and parts[-2] == "tables")):
            names.append(name)
    return names


def cast_tables_(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Store the parameters of ``table_param_names`` as ``dtype``, in place
    (the same ``Parameter`` objects: ties to them hold)."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name in table_param_names(model):
            params[name].data = params[name].data.to(dtype)


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float,
                         sharded: Iterable[torch.Tensor] = (), group=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place, on the device: gradients stay
    as they are when the global norm is below ``max_norm``, else become
    ``g / norm * max_norm``. Returns the norm. ``sharded`` are the gradients
    of row shards, one part of a table on each rank of ``group``: their
    squares are summed over the group, the others' counted once."""
    grads, sharded = list(grads), list(sharded)
    sq = sum((g.float() ** 2).sum() for g in grads)
    if sharded:
        sq = sq + all_reduce_(sum((g.float() ** 2).sum() for g in sharded), group)
        grads = grads + sharded
    norm = torch.sqrt(sq)
    trigger = norm < max_norm
    # dividing by 1 and multiplying by 1 leave a gradient bit-identical
    denom = torch.where(trigger, torch.ones_like(norm), norm)
    mult = torch.where(trigger, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(denom.to(g.dtype)).mul_(mult.to(g.dtype))
    return norm


class Trainer:
    def __init__(
        self,
        model: Model,
        args: T4RecTrainingArguments,
        schema: Optional[Schema] = None,
        train_dataset: Any = None,
        eval_dataset: Any = None,
        test_dataset: Any = None,
        train_dataloader: Optional[Iterable] = None,
        eval_dataloader: Optional[Iterable] = None,
        device=None,
        mesh: Optional[Mesh] = None,
        table_optimizer=None,
    ):
        if args.load_best_model_at_end:
            # a save records the evaluation of the same step: saves must land
            # on evaluation boundaries
            if args.metric_for_best_model is None:
                args.metric_for_best_model = "loss"
            if not (args.save_steps and args.eval_steps):
                raise ValueError("load_best_model_at_end requires save_steps AND eval_steps "
                                 "(saves record the same-step eval metric)")
            if args.save_steps % args.eval_steps != 0:
                raise ValueError(f"load_best_model_at_end: save_steps ({args.save_steps}) must "
                                 f"be a multiple of eval_steps ({args.eval_steps}) so every "
                                 "save lands on an eval boundary")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.args = args
        self.mesh = mesh if mesh is not None else make_mesh(model=args.mesh_model_axis)
        self._check_groups()
        if args.auto_vocab_parallel:
            self._maybe_auto_vocab_parallel()
        self._shard_tables()
        # name -> parameter of every table row-sharded over the model group
        self._row_shards = self._find_row_shards()
        self._shard_ids = {id(p) for p in self._row_shards.values()}
        broadcast_replicas_(self.model, self.mesh, list(self._row_shards.values()))
        if args.embedding_table_dtype == "bf16":
            cast_tables_(self.model, torch.bfloat16)
        self._task_coefs = task_loss_coefficients(self.model)
        self.schema = schema
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.test_dataset = test_dataset
        self._train_dataloader = train_dataloader
        self._eval_dataloader = eval_dataloader
        # (loader-shaping arguments, dataset) of the cached evaluation loader
        self._eval_loader_key: Optional[tuple] = None
        self._tb_writer = None  # made on the first report when report_to asks
        self._last_eval_metrics: Optional[Dict[str, float]] = None
        self._last_eval_step = -1
        self._best_metric: Optional[float] = None
        self._best_checkpoint: Optional[str] = None
        # a host copy of the weights before the first step, for reset_model
        self._initial_state: Optional[Dict[str, torch.Tensor]] = None
        self.state = TrainerState()
        self.optimizers: Dict[str, torch.optim.Optimizer] = {}
        self._table_optimizer = table_optimizer
        self._schedule = None
        self._opt_step = 0  # optimizer steps since the schedule last started
        self._mini_step = 0  # micro-steps since the last update, below K
        self._sparse: Optional[SparseEmbeddingStep] = None
        self._sparse_hint_emitted = False
        self._reader = None  # a sharded checkpoint's shard files while it loads
        self._last_num_steps: Optional[int] = None
        self._generator = torch.Generator(device=self.device).manual_seed(
            self._generator_seed(self.mesh.data_index))
        # (loader_epoch, batches_in_epoch) staged by load() for the next train()
        self._resume_position: Optional[tuple] = None

    # ----------------------------------------------------------------- ranks
    def _generator_seed(self, data_index: int) -> int:
        return self.args.seed + 17 + DATA_SEED_STRIDE * data_index

    @property
    def is_main(self) -> bool:
        """Rank 0 of the layout: the one that logs and writes."""
        return self.mesh.rank == int(self.mesh.ranks[0, 0])

    def _check_groups(self) -> None:
        """A task's own vocab-parallel group of more than one rank must be
        the layout's model group (the same ranks)."""
        row = self.mesh.ranks[self.mesh.data_index].tolist()
        for head in self.model.heads:
            for task in head.tasks:
                group = getattr(task, "vocab_parallel_group", None)
                if group is not None and torch.distributed.get_world_size(group) > 1 \
                        and torch.distributed.get_process_group_ranks(group) != row:
                    raise ValueError(
                        f"task {task.task_name!r} is vocab-parallel over ranks "
                        f"{torch.distributed.get_process_group_ranks(group)}, but this rank's "
                        f"model group in {self.mesh} is {row}")

    @staticmethod
    def _tied_item(head) -> Optional[str]:
        """The item column of ``head`` when a task ties its output to it."""
        tied = any(isinstance(t, NextItemPredictionTask) and t.weight_tying for t in head.tasks)
        return getattr(head.input_module, "item_id", None) if tied else None

    def _maybe_auto_vocab_parallel(self) -> None:
        """Vocab-parallel engagement (the JAX trainer's): with a model axis
        above 1, each tied next-item task whose item table the sharding
        rule takes gets the model group, and the table is replaced by this
        rank's rows (the lookup and the head then read the same shard).
        Sampled-softmax tasks engage too: their evaluation and top-k are
        full-catalogue. A task that has a group keeps it; one without
        ``use_fused_ops`` warns and keeps the table whole (the dense logits
        need every row)."""
        M = self.mesh.model
        if M <= 1:
            return
        for head in self.model.heads:
            item = self._tied_item(head)
            cat = getattr(head.input_module, "categorical_module", None)
            if item is None or cat is None or item not in cat.tables:
                continue
            rows = cat.tables[item].shape[0]
            for task in head.tasks:
                if not (isinstance(task, NextItemPredictionTask) and task.weight_tying
                        and shards_rows(rows, M)) or task.vocab_parallel_group is not None:
                    continue
                if not task.use_fused_ops:
                    warnings.warn(
                        f"mesh_model_axis={M} would row-shard the tied item table ({rows} rows) "
                        "but use_fused_ops=False keeps the dense-logits CE path, which needs "
                        "every row: the table stays whole on every rank; set "
                        "use_fused_ops=True to engage the vocab-parallel kernels")
                    continue
                if item not in cat.table_groups:
                    cat.shard_table(item, self.mesh.model_group)
                task.vocab_parallel_group = self.mesh.model_group

    def _shard_tables(self) -> None:
        """Row-shard every other categorical table the rule takes (JAX
        ``param_shardings``); a tied item table is sharded only with its
        task (``_maybe_auto_vocab_parallel``)."""
        if self.mesh.model <= 1:
            return
        for head in self.model.heads:
            cat = getattr(head.input_module, "categorical_module", None)
            if cat is None or not hasattr(cat, "table_groups"):
                continue
            tied = self._tied_item(head)
            for name in list(cat.tables):
                if name == tied or name in cat.table_groups:
                    continue
                if shards_rows(cat.tables[name].shape[0], self.mesh.model):
                    cat.shard_table(name, self.mesh.model_group)

    def _find_row_shards(self) -> Dict[str, torch.nn.Parameter]:
        shards = {}
        for module in self.model.modules():
            for name, group in getattr(module, "table_groups", {}).items():
                if torch.distributed.get_world_size(group) > 1:
                    shards[id(module.tables[name])] = module.tables[name]
        return {n: p for n, p in self.model.named_parameters() if id(p) in shards}

    # ------------------------------------------------------------ dataloaders
    def _make_loader(self, dataset, batch_size: int, shuffle: bool, is_train: bool = False,
                     pack: bool = False):
        """A dict of numpy columns is held in memory; anything else (a path,
        a list of paths, a ``ParquetDataset``, or nothing under
        ``"synthetic"``) goes to the loader that ``args.data_loader_engine``
        names. Only the training loader drops the tail, and only under
        ``dataloader_drop_last``. ``pack`` packs the sessions several to a
        row."""
        a = self.args
        drop_last = a.dataloader_drop_last if is_train else False
        # batch_size is global: each data row loads its stripe
        stripe, stripes = process_data_stripe(self.mesh)
        batch_size //= stripes
        if isinstance(dataset, dict):
            if pack:
                if self.schema is None:
                    raise ValueError("Trainer: packing needs a schema to find the item ids")
                dataset = pack_sessions(
                    dataset, max_len=a.max_sequence_length or self.schema.sequence_length(20),
                    item_id_col=self.schema.item_id_column_name)
            return InMemoryDataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                                      drop_last=drop_last, seed=a.seed, global_rank=stripe,
                                      global_size=stripes)
        engine = a.data_loader_engine
        if self.schema is None:
            raise ValueError("Trainer: needs a schema to read or synthesize sessions")
        kwargs = {}
        if engine == "parquet_streaming" and a.shuffle_buffer_size > 0:
            kwargs["buffer_rows"] = a.shuffle_buffer_size
        cls = dataloader_registry.parse("parquet" if engine == "merlin" else engine)
        return cls.from_schema(self.schema, dataset, batch_size=batch_size,
                               max_sequence_length=a.max_sequence_length, shuffle=shuffle,
                               drop_last=drop_last, seed=a.seed, pack=pack,
                               global_rank=stripe, global_size=stripes, **kwargs)

    def get_train_dataloader(self):
        if self._train_dataloader is not None:
            return self._train_dataloader
        if self.train_dataset is None and self.args.data_loader_engine != "synthetic":
            raise ValueError("Trainer: training requires a train_dataset")
        return self._make_loader(self.train_dataset, self.args.train_batch_size, shuffle=True,
                                 is_train=True, pack=self.args.pack_sessions)

    def get_eval_dataloader(self, eval_dataset=None):
        """The loader of ``eval_dataset``, else of ``self.eval_dataset``. The
        latter is cached, keyed by the loader-shaping arguments and the
        dataset object (``fit_and_evaluate`` assigns another one each
        window)."""
        a = self.args
        ds = eval_dataset if eval_dataset is not None else self.eval_dataset
        cfg = (a.eval_batch_size, a.max_sequence_length, a.data_loader_engine, a.seed,
               a.pack_eval_sessions)
        if eval_dataset is None and self._eval_dataloader is not None:
            cached = self._eval_loader_key
            if cached is None or (cached[0] == cfg and cached[1] is ds):
                return self._eval_dataloader
        if ds is None and a.data_loader_engine != "synthetic":
            raise ValueError("Trainer: evaluation requires an eval_dataset")
        loader = self._make_loader(ds, a.eval_batch_size, shuffle=False,
                                   pack=a.pack_eval_sessions)
        if eval_dataset is None:
            self._eval_dataloader, self._eval_loader_key = loader, (cfg, ds)
        return loader

    def get_test_dataloader(self, test_dataset=None):
        ds = test_dataset if test_dataset is not None else self.test_dataset
        if ds is None and self.args.data_loader_engine != "synthetic":
            raise ValueError("Trainer: prediction requires a test_dataset")
        return self._make_loader(ds, self.args.eval_batch_size, shuffle=False)

    # ------------------------------------------------------------- optimizer
    def num_training_steps(self, train_loader) -> int:
        if self.args.max_steps > 0:
            return self.args.max_steps
        return max(int(len(train_loader) * self.args.num_train_epochs), 1)

    def create_optimizer_and_scheduler(self, num_training_steps: int):
        a = self.args
        self._last_num_steps = num_training_steps
        num_cycles = 0.5
        if a.lr_scheduler_type.startswith("cosine"):
            num_cycles = num_cosine_cycles(a.num_train_epochs,
                                           a.learning_rate_num_cosine_cycles_by_epoch)
        self._schedule = get_scheduler(a.lr_scheduler_type, a.learning_rate, a.warmup_steps,
                                       num_training_steps, num_cycles=num_cycles)
        self._sparse = None
        if a.embedding_optimizer in SPARSE_OPTIMIZERS:
            self._sparse = SparseEmbeddingStep(
                self.model, a,
                rule="adafactor" if a.embedding_optimizer == "sparse_adafactor" else "adam",
                data_group=self.mesh.data_group)
        self._reset_accumulation()
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad and (self._sparse is None or p is not self._sparse.table)]
        labels = label_embedding_params(named)
        tables = [p for n, p in named if labels[n] == "table"]
        dense = [p for n, p in named if labels[n] == "dense"]
        if a.embedding_optimizer == "dense":
            dense, tables = dense + tables, []
        self.optimizers = {
            "dense": torch.optim.AdamW(
                dense, lr=self._schedule(0), betas=(a.adam_beta1, a.adam_beta2),
                eps=a.adam_epsilon, weight_decay=a.weight_decay,
            )
        }
        if tables and self._table_optimizer is not None:
            self.optimizers["table"] = self._table_optimizer(tables, self._schedule)
        elif tables and a.embedding_optimizer == "lazy_adam":
            self.optimizers["table"] = LazyAdam(tables, lr=self._schedule,
                                                betas=(a.adam_beta1, a.adam_beta2),
                                                eps=a.adam_epsilon)
        elif tables:
            self.optimizers["table"] = FusedAdafactor(
                tables, lr=self._schedule,
                moment_dtype=torch.bfloat16 if a.embedding_moment_dtype == "bf16" else None,
            )
        for opt in self.optimizers.values():
            if isinstance(opt, FusedAdafactor):
                # its clip and factored means go over the whole table
                opt.row_shards = {p: self.mesh.model_group for p in self._row_shards.values()}
        return self.optimizers

    def _reset_accumulation(self) -> None:
        """No micro-step pending: the summed gradients go."""
        self._mini_step = 0
        self.model.zero_grad(set_to_none=True)

    def reset_lr_scheduler(self) -> None:
        """Restart the schedule for a new incremental time window: fresh
        optimizer state (the sparse rows' too) and no pending accumulation;
        the parameters stay."""
        if not self.optimizers:
            return
        self.create_optimizer_and_scheduler(self._last_num_steps)
        self._opt_step = 0

    def reset_model(self) -> None:
        """Start again from the weights the first ``train()`` started from,
        with no optimizer state: each window of ``fit_and_evaluate(...,
        no_incremental_training=True)`` trains from the initial weights.
        ``global_step`` stays monotonic."""
        if self._initial_state is not None:
            load_weights(self.model, self._initial_state)
        self.optimizers = {}
        self._sparse = None
        self._reset_accumulation()
        self._opt_step = 0

    def _maybe_hint_sparse_adam(self) -> None:
        """Once per trainer: a model that qualifies for the sparse step, with
        a tied item table of at least ``SPARSE_HINT_MIN_ROWS`` rows, trained
        on a dense table arm hears of ``sparse_adam``."""
        a = self.args
        if self._sparse_hint_emitted or a.embedding_optimizer in SPARSE_OPTIMIZERS:
            return
        heads = list(self.model.heads)
        if len(heads) != 1 or heads[0].input_module.item_id is None:
            return
        rows = heads[0].input_module.item_embedding_table().shape[0]
        if self._row_shards:
            rows *= self.mesh.model
        if rows < SPARSE_HINT_MIN_ROWS:
            return
        try:
            validate_sparse_config(self.model)
        except (NotImplementedError, ValueError):
            return
        self._sparse_hint_emitted = True
        warnings.warn(
            f"the tied item table has {rows:,} rows and this model qualifies for "
            "embedding_optimizer='sparse_adam' (O(N·E) row updates — no dense (V, E) "
            "gradient or full optimizer-state walk): consider it over "
            f"{a.embedding_optimizer!r} at this scale")

    # ------------------------------------------------------------------ steps
    def _train_step(self, batch: Dict[str, torch.Tensor],
                    masking_info: Optional[MaskingInfo] = None) -> torch.Tensor:
        """One micro-step on a batch that is already on the device, and the
        optimizer update when it completes ``gradient_accumulation_steps``
        of them. Returns the loss as a device scalar; nothing is read back.
        ``masking_info`` (the mask, and the negatives in its ``neg_ids``)
        replaces the step's own draw: a card and a CPU given one draw take
        the same step."""
        a = self.args
        k = max(a.gradient_accumulation_steps, 1)
        if self._mini_step == 0:
            self.model.zero_grad(set_to_none=True)
        if self._sparse is not None:
            loss = self._sparse.forward_backward(batch, self._generator, masking_info,
                                                 backward=self._backward)
        else:
            loss, outs = self.model(batch, targets=batch, training=True, compute_metrics=False,
                                    generator=self._generator, masking_info=masking_info)
            loss = self._backward(loss, outs)
        self._mini_step += 1
        if self._mini_step < k:
            return loss
        self._mini_step = 0
        params = [p for p in self.model.parameters() if p.grad is not None]
        # the data replicas' gradients, summed once per update
        all_reduce_grads_(params, self.mesh.data_group)
        grads = [p.grad for p in params if id(p) not in self._shard_ids]
        sharded = [p.grad for p in params if id(p) in self._shard_ids]
        if k > 1:
            for g in grads + sharded:
                g.div_(k)
        lr = self._schedule(self._opt_step)
        if self._sparse is not None:
            # the clip there covers the dense gradients and the rows' jointly
            self._sparse.apply(grads, lr, k, sharded=sharded, group=self.mesh.model_group)
        elif a.max_grad_norm and a.max_grad_norm > 0:
            clip_by_global_norm_(grads, a.max_grad_norm, sharded, self.mesh.model_group)
        for group in self.optimizers["dense"].param_groups:
            group["lr"] = lr
        for opt in self.optimizers.values():
            opt.step()
        self._opt_step += 1
        return loss

    def _backward(self, loss: torch.Tensor, outs) -> torch.Tensor:
        """Backpropagate one micro-step's loss; returns its value as a device
        scalar. Over a data axis the objective is this rank's share of the
        global weighted mean, and the value that mean."""
        if self.mesh.data_group is None:
            loss.backward()
            return loss.detach()
        objective, value = data_parallel_loss(self._task_coefs, outs, self.mesh.data_group)
        objective.backward()
        return value

    # ------------------------------------------------------------------ train
    def train(self, resume_from_checkpoint=None) -> Dict[str, float]:
        """Train for ``num_training_steps``. ``resume_from_checkpoint``
        (``True``: the latest ``checkpoint-*`` under ``output_dir``; a string:
        that path) continues the original schedule and, with ``max_steps``
        set, runs only the remaining steps."""
        a = self.args
        loader = self.get_train_dataloader()
        num_steps = self.num_training_steps(loader)
        if self._initial_state is None:
            self._initial_state = {k: v.detach().to("cpu", copy=True)
                                   for k, v in self.model.state_dict().items()}
        if not self.optimizers:
            self.create_optimizer_and_scheduler(num_steps)
        self._maybe_hint_sparse_adam()
        if resume_from_checkpoint:
            path = (resume_from_checkpoint if isinstance(resume_from_checkpoint, str)
                    else self._latest_checkpoint())
            if not path:
                raise ValueError("resume_from_checkpoint=True but no checkpoint-* "
                                 f"directory under {a.output_dir}")
            self.load(path)
            if a.max_steps > 0:
                num_steps = max(a.max_steps - self.state.global_step, 0)
        K = max(int(a.steps_per_execution), 1)
        self.state.past_global_steps = self.state.global_step
        window = (tuple(int(x) for x in a.profile_steps.split(","))
                  if a.profile_steps else None)
        profiler = None
        pbar = None
        if not a.disable_tqdm and self.is_main:
            try:
                from tqdm.auto import tqdm

                pbar = tqdm(total=num_steps, desc="train", unit="step")
            except ImportError:
                pass

        start = time.time()
        loss_sum = torch.zeros((), device=self.device)  # device-side running sum
        step_in_run = 0
        n_examples = 0
        epochs = math.inf if a.max_steps > 0 else a.num_train_epochs
        done = num_steps <= 0
        epoch = 0
        pos, self._resume_position = self._resume_position, None
        if pos and (pos[0] > 0 or pos[1] > 0) and hasattr(loader, "set_state"):
            loader.set_state(*pos)
        else:
            self.state.batches_in_epoch = 0

        def dispatch(group) -> None:
            """Copy the group's batches to the device, then enqueue one
            optimizer step per batch; the host reads a loss only at a
            logging boundary or the end of the run."""
            nonlocal step_in_run, n_examples, done, loss_sum
            on_device = [self.model._as_dense(b, a.max_sequence_length, non_blocking=True)
                         for b in group]
            step_losses = [self._train_step(b) for b in on_device]
            loss_sum = loss_sum + torch.stack(step_losses).sum()
            for i, b in enumerate(on_device):
                step_in_run += 1
                self.state.global_step = self.state.past_global_steps + step_in_run
                self.state.batches_in_epoch += 1
                n_examples += next(iter(b.values())).shape[0] * self.mesh.data
                if (a.logging_steps and step_in_run % a.logging_steps == 0) \
                        or step_in_run == num_steps:
                    loss = float(step_losses[i])
                    self.state.log_history.append({"loss": loss, "step": self.state.global_step})
                    self._report({"train/loss": loss}, self.state.global_step)
            if pbar is not None:
                pbar.update(len(group))
            # an evaluation runs before a save at the same step, so that the
            # best-checkpoint tracking reads this step's metric
            if a.eval_steps and step_in_run % a.eval_steps == 0 and self._has_eval_data():
                self.evaluate()
            if a.save_steps and step_in_run % a.save_steps == 0:
                self._save_checkpoint()
            if step_in_run >= num_steps:
                done = True

        while not done and epoch < epochs:
            self.state.loader_epoch = getattr(loader, "_epoch", self.state.loader_epoch)
            pending: List[Dict[str, Any]] = []
            epoch_batches = 0
            for batch in loader:
                epoch_batches += 1
                if window and profiler is None and step_in_run == window[0]:
                    profiler = self._start_profiler()
                pending.append(batch)
                # a group never crosses the run's end, a save or an evaluation
                # boundary: both must see the state exactly at that step
                k_target = min(K, num_steps - step_in_run)
                for every in (a.save_steps, a.eval_steps):
                    if every:
                        k_target = min(k_target, every - (step_in_run % every))
                if window is not None:
                    k_target = 1  # the trace's edges fall on steps
                if len(pending) < k_target:
                    continue
                dispatch(pending)
                pending = []
                if profiler is not None and step_in_run >= window[1]:
                    self._stop_profiler(profiler, window)
                    profiler, window = None, None
                if done:
                    break
            else:
                # the whole epoch was consumed: flush the < K tail
                for b in pending:
                    if not done:
                        dispatch([b])
                self.state.batches_in_epoch = 0
            if epoch_batches == 0 and not done:
                raise ValueError("the train dataloader yielded no batches")
            epoch += 1
            self.state.epoch = epoch

        if profiler is not None:  # the run ended inside the window
            self._stop_profiler(profiler, window)
        if pbar is not None:
            pbar.close()
        self.wait_for_checkpoints()
        if a.load_best_model_at_end:
            if self._best_checkpoint and os.path.isdir(self._best_checkpoint):
                # the best weights only: step, history and optimizers stay
                self._load_params_only(self._best_checkpoint)
            elif a.metric_for_best_model:
                warnings.warn(f"load_best_model_at_end: no checkpoint recorded "
                              f"{a.metric_for_best_model!r} (set eval_steps at save "
                              "boundaries); keeping final parameters")
        runtime = time.time() - start
        metrics = {
            "train_loss": float(loss_sum) / step_in_run if step_in_run else float("nan"),
            "train_runtime": runtime,
            "train_samples_per_second": n_examples / max(runtime, 1e-9),
            "train_steps": step_in_run,
            "global_step": self.state.global_step,
        }
        self.state.log_history.append(metrics)
        self._report(metrics, self.state.global_step)
        self._log_json(metrics)
        return metrics

    def _start_profiler(self):
        """A ``torch.profiler`` recording CPU activity, and the card's."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, window) -> str:
        """Stop ``profiler`` once the device is done and write its Chrome
        trace under ``profile_dir`` (default ``output_dir/profile``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = self.args.profile_dir or os.path.join(self.args.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace-steps-{window[0]}-{window[1]}-rank{self.mesh.rank}.json")
        profiler.export_chrome_trace(path)
        return path

    def _report(self, record: Dict[str, Any], step: int) -> None:
        """Numeric scalars to TensorBoard under ``{output_dir}/runs`` when
        ``args.report_to`` names it (rank 0's)."""
        if "tensorboard" not in str(self.args.report_to) or not self.is_main:
            return
        if self._tb_writer is None:
            from torch.utils.tensorboard import SummaryWriter

            self._tb_writer = SummaryWriter(log_dir=os.path.join(self.args.output_dir, "runs"))
        for k, v in record.items():
            if k in ("step", "global_step") or isinstance(v, bool) \
                    or not isinstance(v, (int, float)):
                continue
            self._tb_writer.add_scalar(k, v, step)
        self._tb_writer.flush()

    def _log_json(self, record: Dict[str, Any]) -> None:
        """Append a metrics record to ``{output_dir}/metrics.jsonl`` when
        ``args.log_json`` is set (rank 0's)."""
        if not self.args.log_json or not self.is_main:
            return
        os.makedirs(self.args.output_dir, exist_ok=True)
        with open(os.path.join(self.args.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"global_step": self.state.global_step,
                                "experiments_group": self.args.experiments_group,
                                **record}) + "\n")

    # --------------------------------------------------------------- evaluate
    def _has_eval_data(self) -> bool:
        return (self._eval_dataloader is not None or self.eval_dataset is not None
                or self.args.data_loader_engine == "synthetic")

    def evaluate(self, eval_dataset=None, metric_key_prefix: str = "eval",
                 on_train_set: bool = False, max_steps: Optional[int] = None) -> Dict[str, float]:
        """``Model.evaluate`` over the evaluation loader (with
        ``on_train_set``, over the training loader, at most
        ``args.eval_steps_on_train_set`` batches, under the prefix
        ``{metric_key_prefix}_train``). The result, with its runtime, is
        appended to ``state.log_history`` with the global step."""
        a = self.args
        if on_train_set:
            loader = self.get_train_dataloader()
            max_steps = max_steps or a.eval_steps_on_train_set
            metric_key_prefix = f"{metric_key_prefix}_train"
        else:
            loader = self.get_eval_dataloader(eval_dataset)
        n_examples = 0

        def counted():
            nonlocal n_examples
            for batch in itertools.islice(loader, max_steps):
                n_examples += len(next(iter(batch.values()))) * self.mesh.data
                yield batch

        start = time.time()
        out = self.model.evaluate(counted(), mode=metric_key_prefix,
                                  max_sequence_length=a.max_sequence_length,
                                  compute_metrics_each_n_steps=a.compute_metrics_each_n_steps,
                                  data_group=self.mesh.data_group)
        runtime = time.time() - start
        loss_key = f"{metric_key_prefix}_loss"
        results = {loss_key: out.pop(loss_key),
                   f"{metric_key_prefix}_runtime": runtime,
                   f"{metric_key_prefix}_samples_per_second": n_examples / max(runtime, 1e-9),
                   **out}
        self.state.log_history.append({**results, "step": self.state.global_step})
        self._report(results, self.state.global_step)
        self._log_json(results)
        if metric_key_prefix == "eval":
            # read by the best-checkpoint tracking of a save at the same step
            self._last_eval_metrics = results
            self._last_eval_step = self.state.global_step
        if a.log_predictions and not on_train_set:
            self.log_predictions(eval_dataset, metric_key_prefix=metric_key_prefix)
        return results

    def predict(self, test_dataset=None, top_k: Optional[int] = None):
        """Top-k next-item ``(scores, ids)`` as numpy arrays, one row per
        session of ``test_dataset`` (else ``self.test_dataset``): the
        zero-filled tail is cut to the loader's ``num_rows``. ``k`` is
        ``top_k``, else ``args.predict_top_k``, else ``model.top_k``. Over a
        data axis each data row predicts its stripe and the stripes are
        gathered in the dataset's order, on every rank."""
        a = self.args
        loader = self.get_test_dataloader(test_dataset)
        group = self.mesh.data_group
        if group is not None and getattr(loader, "_stripe_groups", False):
            raise ValueError("predict over a data axis needs rows striped one by one, not "
                             "row groups: use the 'parquet' engine")
        k = top_k or a.predict_top_k or self.model.top_k
        all_scores, all_ids = [], []
        with torch.inference_mode():
            for batch in loader:
                scores, ids = self.model(self.model._as_dense(batch, a.max_sequence_length),
                                         top_k=k)
                all_scores.append(scores)
                all_ids.append(ids)
        scores, ids = torch.cat(all_scores), torch.cat(all_ids)
        num_rows = getattr(loader, "num_rows", None)
        if group is not None:
            num_rows = loader.total_rows
            scores, ids = (interleave_stripes(list(all_gather_rows(t[None], group)), num_rows)
                           for t in (scores, ids))
        # one copy to the host at the end
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        if num_rows is not None and len(scores) > num_rows:
            scores, ids = scores[:num_rows], ids[:num_rows]
        return scores, ids

    def log_predictions(self, dataset=None, metric_key_prefix: str = "eval") -> str:
        """Write the top-k of ``dataset`` (else the evaluation data) to
        ``{output_dir}/pred_logs_{prefix}_{global_step}.parquet``, with list
        columns ``pred_item_ids`` and ``pred_item_scores``. Returns the
        path."""
        import pandas as pd

        scores, ids = self.predict(dataset if dataset is not None else self.eval_dataset)
        path = os.path.join(self.args.output_dir,
                            f"pred_logs_{metric_key_prefix}_{self.state.global_step}.parquet")
        if self.is_main:
            os.makedirs(self.args.output_dir, exist_ok=True)
            pd.DataFrame({"pred_item_ids": list(map(list, ids)),
                          "pred_item_scores": list(map(list, scores.astype(float)))}
                         ).to_parquet(path)
        barrier(self.mesh, self.device)
        return path

    # ------------------------------------------------------------ checkpoints
    def _latest_checkpoint(self) -> Optional[str]:
        root = self.args.output_dir
        if not os.path.isdir(root):
            return None
        done = [(int(d.split("-")[1]), d) for d in os.listdir(root)
                if d.startswith("checkpoint-") and d.split("-")[1].isdigit()
                and checkpoint_complete(os.path.join(root, d))]
        return os.path.join(root, max(done)[1]) if done else None

    def _save_checkpoint(self) -> str:
        path = os.path.join(self.args.output_dir, f"checkpoint-{self.state.global_step}")
        self.save(path)
        self._track_best_checkpoint(path)
        self._rotate_checkpoints()
        return path

    def _track_best_checkpoint(self, path: str) -> None:
        """Record ``path`` as the best checkpoint when
        ``args.metric_for_best_model`` improved at the evaluation of this
        step (only under ``load_best_model_at_end``)."""
        a = self.args
        metrics = self._last_eval_metrics
        if not (a.load_best_model_at_end and a.metric_for_best_model and metrics):
            return
        if self._last_eval_step != self.state.global_step:
            return  # a save between evaluations claims no metric
        key = a.metric_for_best_model
        if key not in metrics and not key.startswith("eval_"):
            key = f"eval_{key}"
        if key not in metrics:
            # a bare name ('recall_at_10') resolves to the one task key that
            # ends in it ('eval_/next-item/recall_at_10')
            suffix = a.metric_for_best_model.lstrip("/")
            candidates = [k for k in metrics if k.endswith(f"/{suffix}")]
            if len(candidates) != 1:
                raise ValueError(f"metric_for_best_model={a.metric_for_best_model!r} does not "
                                 f"match any eval metric; available: {sorted(metrics)}")
            key = candidates[0]
        value = float(metrics[key])
        greater = a.greater_is_better
        if greater is None:
            greater = "loss" not in a.metric_for_best_model
        if self._best_metric is None or (value > self._best_metric if greater
                                         else value < self._best_metric):
            self._best_metric, self._best_checkpoint = value, path

    def _rotate_checkpoints(self) -> None:
        """Keep the newest ``args.save_total_limit`` checkpoints and the best
        (rank 0 removes them)."""
        limit = self.args.save_total_limit
        if not limit or not self.is_main:
            return
        self.wait_for_checkpoints()
        root = self.args.output_dir
        keep = os.path.basename(self._best_checkpoint or "")
        done = sorted((d for d in os.listdir(root) if d.startswith("checkpoint-")),
                      key=lambda d: int(d.split("-")[1]))
        for d in done[:-limit]:
            if d != keep:
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    def wait_for_checkpoints(self) -> None:
        """Block until every asynchronous checkpoint write of this process
        is on disk (none without ``save_async``)."""
        wait_all_pending()

    def save(self, path: str, blocking: Optional[bool] = None) -> None:
        """Write the model, the optimizers (the sparse rows' state too), the
        trainer state, the generators, the loader position and a pending
        accumulation (its micro-step, the summed gradients, the sparse arm's
        buffered rows) under ``path``, in ``args.checkpoint_format``
        (``trainer/checkpoint.py``): ``"torch"``, the row shards gathered to
        rank 0, which writes the one-rank format to ``trainer.pt``, or
        ``"sharded"``, each rank of data row 0 its own rows and rank 0 the
        rest. One generator a data row. Over ranks every rank takes part.

        A snapshot of all of it is taken to host memory on the caller's
        thread; with ``blocking=False`` (the default under
        ``args.save_async``) the files are written on a thread, and the live
        state may move on as soon as this returns. Each file is renamed into
        place when whole, the completion marker of its part.

        Part-way through gradient accumulation over a data axis, the
        pending gradients are saved summed over the data group (and the
        sparse arm's buffered rows gathered over it); ``load`` gives them
        to data row 0 and zeros to the others, so that the resumed update
        sums to the unbroken one."""
        if blocking is None:
            blocking = not self.args.save_async
        # one save in flight at a time; the barrier at the end orders every
        # rank's earlier writes before this save's
        self.wait_for_checkpoints()
        m = self.mesh
        # every data row's generator; the model group's gathers run in data row 0
        states = all_gather_rows(self._generator.get_state().to(self.device)[None], None
                                 if m.size == 1 else torch.distributed.group.WORLD)
        # copies: a generator reads its state from the start of the storage
        generators = [states[int(r)].cpu().clone() for r in m.ranks[:, 0]]
        grads, sparse_accum = {}, None
        if self._mini_step:
            grads = {n: p.grad for n, p in self.model.named_parameters() if p.grad is not None}
            if m.data_group is not None:
                grads = self._summed_over_data(grads)
                if self._sparse is not None:
                    acc = self._sparse.accum
                    sparse_accum = {k: [all_gather_rows(t, m.data_group) for t in v]
                                    for k, v in (("ids", acc.ids), ("grads", acc.grads))}
        sharded = self.args.checkpoint_format == "sharded"
        shards = RowShards(m.model if self._row_shards else 0)
        rows_of = shards if sharded else (lambda t: all_gather_rows(t, m.model_group))
        files = {}
        if m.data_index == 0:
            sparse = self._sparse_doc(lambda tree, shard: self._rows_of(tree, shard, rows_of))
            if sparse_accum is not None:
                sparse = {**sparse, "accum": sparse_accum}
            doc = {
                "model": self._shards_of(self.model.state_dict(), rows_of),
                "optimizers": {k: self._opt_of(opt, rows_of) for k, opt in self.optimizers.items()},
                "trainer_state": dataclasses.asdict(self.state),
                "opt_step": self._opt_step,
                "num_training_steps": self._last_num_steps,
                "generators": generators,
                # a resume part-way through an accumulation continues it exactly
                "mini_step": self._mini_step,
                "grads": self._shards_of(grads, rows_of),
                "sparse": sparse,
            }
            if sharded:
                if shards.local:
                    files[rows_file(m.model_index, shards.shards)] = shards.local
                if self.is_main:
                    files[replicated_file(shards.shards)] = doc
            elif self.is_main:
                files[CHECKPOINT_FILE] = doc
        write_files(path, snapshot(files), blocking)
        barrier(m, self.device)

    def _summed_over_data(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Copies of ``grads`` summed over the data group, in one collective
        (the live gradients stay this rank's)."""
        if not grads:
            return grads
        flat = all_reduce_(torch.cat([g.reshape(-1).float() for g in grads.values()]),
                           self.mesh.data_group)
        out, offset = {}, 0
        for n, g in grads.items():
            out[n] = flat[offset:offset + g.numel()].view_as(g).to(g.dtype)
            offset += g.numel()
        return out

    # a row shard's state over the model group: gathered whole (``"torch"``)
    # or filed as this rank's rows (``"sharded"``) by ``rows_of`` to save;
    # this rank's rows taken again to load
    def _shards_of(self, state: Dict[str, torch.Tensor], rows_of) -> Dict[str, object]:
        return {k: rows_of(v) if k in self._row_shards else v for k, v in state.items()}

    def _rows_here(self, t, sharded: bool):
        """This rank's rows of a checkpoint's whole tensor when ``sharded``
        here, else all of them: ``t`` a tensor, or a ``RowShard`` of a
        sharded checkpoint, read from its shard files."""
        m = self.mesh
        if isinstance(t, RowShard):
            if not sharded:
                return self._reader.rows(t, 0, t.rows)
            per = t.rows // m.model
            return self._reader.rows(t, m.model_index * per, (m.model_index + 1) * per)
        return take_shard(t, m.model_index, m.model) if sharded else t

    def _local_shards(self, state: Dict[str, object]) -> Dict[str, torch.Tensor]:
        return {k: self._rows_here(v, k in self._row_shards) for k, v in state.items()}

    def _rows_of(self, tree, shard: torch.Tensor, rows_of):
        """``tree`` (nested dicts and lists) with every tensor of ``shard``'s
        rows passed through ``rows_of``."""
        if isinstance(tree, dict):
            return {k: self._rows_of(v, shard, rows_of) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._rows_of(v, shard, rows_of) for v in tree]
        if torch.is_tensor(tree) and tree.dim() and tree.shape[0] == shard.shape[0] \
                and id(shard) in self._shard_ids:
            return rows_of(tree)
        return tree

    def _local_rows_of(self, tree, shard: torch.Tensor):
        """The inverse of ``_rows_of``: this rank's rows of every tensor with
        the whole table's rows."""
        if isinstance(tree, dict):
            return {k: self._local_rows_of(v, shard) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._local_rows_of(v, shard) for v in tree]
        rows = tree.rows if isinstance(tree, RowShard) else (
            tree.shape[0] if torch.is_tensor(tree) and tree.dim() else None)
        if rows is None:
            return tree
        return self._rows_here(tree, rows == shard.shape[0] * self.mesh.model
                               and id(shard) in self._shard_ids)

    def _sparse_doc(self, rows_of, doc: Optional[dict] = None) -> Optional[dict]:
        """The sparse arm's checkpoint entry with its rows' state (not its
        accumulation buffers, the same on every rank of a model group) passed
        through ``rows_of``."""
        if self._sparse is None:
            return None
        doc = self._sparse.state_dict() if doc is None else doc
        return {**doc, "state": rows_of(doc["state"], self._sparse.table)}

    def _opt_params(self, opt) -> List[torch.Tensor]:
        return [p for group in opt.param_groups for p in group["params"]]

    def _opt_of(self, opt, rows_of) -> dict:
        sd = opt.state_dict()
        params = self._opt_params(opt)
        # new dicts: state_dict() shares each parameter's state with the optimizer
        sd["state"] = {i: self._rows_of(dict(st), params[i], rows_of)
                       for i, st in sd["state"].items()}
        return sd

    def _local_opt(self, opt, sd: dict) -> dict:
        params = self._opt_params(opt)
        return {**sd, "state": {i: self._local_rows_of(dict(st), params[i])
                                for i, st in sd["state"].items()}}

    def _read_checkpoint(self, path: str) -> dict:
        """The checkpoint at ``path`` in either format (found from its
        files), its model's row shards already this rank's rows. A sharded
        checkpoint's other row-sharded tensors stay ``RowShard``
        references, read by ``_local_rows_of`` (``self._reader``)."""
        # every rank's writes, this one's and (the barrier) the others'
        self.wait_for_checkpoints()
        barrier(self.mesh, self.device)
        shards = None if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)) \
            else sharded_shards(path)
        if shards is None:
            doc = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=self.device,
                             weights_only=False)
            self._reader = None
        else:
            doc = torch.load(os.path.join(path, replicated_file(shards)),
                             map_location=self.device, weights_only=False)
            self._reader = ShardReader(path)
        doc["model"] = self._local_shards(doc["model"])
        return doc

    def _load_params_only(self, path: str) -> None:
        """The weights of a checkpoint; optimizers, generator and state stay."""
        load_weights(self.model, self._to_device(self._read_checkpoint(path)["model"]))
        self._reader = None

    def _to_device(self, tree):
        """``tree`` on the device: rows read from shard files (host memory)
        moved there, a ``RowShard`` still in it read whole."""
        if isinstance(tree, dict):
            return {k: self._to_device(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._to_device(v) for v in tree]
        if isinstance(tree, RowShard):
            tree = self._reader.rows(tree, 0, tree.rows)
        return tree.to(self.device) if torch.is_tensor(tree) else tree

    def load(self, path: str) -> None:
        """Restore a checkpoint ``save`` wrote, on this layout of ranks
        whatever the layout that wrote it: row shards take this rank's rows.
        A data row that the writer did not have reseeds its generator."""
        doc = self._read_checkpoint(path)
        load_weights(self.model, self._to_device(doc["model"]))
        # data row 0 takes pending gradients summed over the data group
        first_row = self.mesh.data_index == 0
        if doc["optimizers"]:
            self.create_optimizer_and_scheduler(doc["num_training_steps"])
            for k, sd in doc["optimizers"].items():
                self.optimizers[k].load_state_dict(
                    self._to_device(self._local_opt(self.optimizers[k], sd)))
            if doc.get("sparse") is not None:
                sparse = self._to_device(self._sparse_doc(self._local_rows_of, doc["sparse"]))
                if not first_row:
                    acc = sparse["accum"]
                    sparse["accum"] = {**acc, "grads": [torch.zeros_like(g) for g in acc["grads"]]}
                self._sparse.load_state_dict(sparse)
        self._opt_step = doc["opt_step"]
        self._mini_step = doc.get("mini_step", 0)
        params = dict(self.model.named_parameters())
        for n, g in self._to_device(self._local_shards(doc.get("grads", {}))).items():
            params[n].grad = g.to(params[n].device) if first_row else torch.zeros_like(params[n])
        self.state = TrainerState(**doc["trainer_state"])
        generators = doc["generators"] if "generators" in doc else [doc["generator"]]
        if self.mesh.data_index < len(generators):
            self._generator.set_state(generators[self.mesh.data_index].cpu())
        else:
            self._generator.manual_seed(self._generator_seed(self.mesh.data_index))
        self._resume_position = (self.state.loader_epoch, self.state.batches_in_epoch)
        self._reader = None

    def wipe_memory(self) -> None:
        """Free what a time window leaves behind: a garbage collection, and
        the card's cached blocks."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
