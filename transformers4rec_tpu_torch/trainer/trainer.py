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
  ``embedding_optimizer="dense"``, or what ``table_optimizer(tables,
  schedule)`` returns when the caller gives one (``flagship.build_trainer``
  hands in the streamed table update that way).

``steps_per_execution = K``: K optimizer steps are enqueued on the device
between host reads of the loss, and the K batches are copied to the device
before the first of them, so nothing synchronises inside a group. A group
never crosses the run's end, an evaluation or a save boundary, losses are
read after the group that holds a logging step, and the trajectory equals
K = 1 bit for bit. All random draws of a step (the
mask, then dropout) come from one ``torch.Generator`` on the model's device,
seeded from ``args.seed`` and saved with a checkpoint.

``save`` / ``load`` write one ``torch.save`` file with the model, both
optimizers, the generator and the loader position; ``train(resume_from_
checkpoint=path)`` finishes an interrupted ``max_steps`` run exactly. Not
ported yet (raise where reached): a device mesh, training over a process
group of more than one rank, the sparse embedding step, asynchronous and sharded checkpoints,
``predict``, ``log_predictions`` and the incremental time-window loops.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed

from ..data.loader import InMemoryDataLoader, SyntheticDataLoader
from ..model.base import Model
from ..ops.fused_adafactor import FusedAdafactor
from ..ops.sparse_update import label_embedding_params
from ..schema import Schema
from ..utils.device import resolve_device
from .arguments import T4RecTrainingArguments
from .schedulers import get_scheduler, num_cosine_cycles

CHECKPOINT_FILE = "trainer.pt"


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


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place, on the device: gradients stay
    as they are when the global norm is below ``max_norm``, else become
    ``g / norm * max_norm``. Returns the norm."""
    grads = list(grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
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
        train_dataloader: Optional[Iterable] = None,
        eval_dataloader: Optional[Iterable] = None,
        device=None,
        mesh=None,
        table_optimizer=None,
    ):
        if mesh is not None:
            raise NotImplementedError("a device mesh (sharded training) is not ported yet")
        for head in model.heads:
            for task in head.tasks:
                group = getattr(task, "vocab_parallel_group", None)
                if group is not None and torch.distributed.get_world_size(group) > 1:
                    raise NotImplementedError(
                        "training over a process group of more than one rank is not ported yet"
                    )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.args = args
        self.schema = schema
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self._train_dataloader = train_dataloader
        self._eval_dataloader = eval_dataloader
        self.state = TrainerState()
        self.optimizers: Dict[str, torch.optim.Optimizer] = {}
        self._table_optimizer = table_optimizer
        self._schedule = None
        self._opt_step = 0  # optimizer steps since the schedule last started
        self._last_num_steps: Optional[int] = None
        self._generator = torch.Generator(device=self.device).manual_seed(args.seed + 17)
        # (loader_epoch, batches_in_epoch) staged by load() for the next train()
        self._resume_position: Optional[tuple] = None

    # ------------------------------------------------------------ dataloaders
    def _make_loader(self, dataset, batch_size: int, shuffle: bool, drop_last: bool):
        """A dict of numpy columns is loaded from memory; without a dataset
        the sessions are synthesized from the schema."""
        if isinstance(dataset, dict):
            return InMemoryDataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                                      drop_last=drop_last, seed=self.args.seed)
        if dataset is None:
            if self.schema is None:
                raise ValueError("Trainer: needs a dataset, or a schema to synthesize one from")
            return SyntheticDataLoader.from_schema(
                self.schema, batch_size=batch_size,
                max_sequence_length=self.args.max_sequence_length,
                shuffle=shuffle, drop_last=drop_last, seed=self.args.seed,
            )
        raise NotImplementedError(
            "only a dict of numpy columns is loaded: the Parquet loaders are not ported yet"
        )

    def get_train_dataloader(self):
        if self._train_dataloader is not None:
            return self._train_dataloader
        return self._make_loader(self.train_dataset, self.args.train_batch_size, shuffle=True,
                                 drop_last=self.args.dataloader_drop_last)

    def get_eval_dataloader(self, eval_dataset=None):
        if eval_dataset is None and self._eval_dataloader is not None:
            return self._eval_dataloader
        ds = eval_dataset if eval_dataset is not None else self.eval_dataset
        # evaluation never drops tail sessions
        return self._make_loader(ds, self.args.eval_batch_size, shuffle=False, drop_last=False)

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
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
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
        elif tables:
            self.optimizers["table"] = FusedAdafactor(
                tables, lr=self._schedule,
                moment_dtype=torch.bfloat16 if a.embedding_moment_dtype == "bf16" else None,
            )
        return self.optimizers

    def reset_lr_scheduler(self) -> None:
        """Restart the schedule for a new incremental time window: fresh
        optimizer state, the parameters stay."""
        if not self.optimizers:
            return
        self.create_optimizer_and_scheduler(self._last_num_steps)
        self._opt_step = 0

    # ------------------------------------------------------------------ steps
    def _train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a batch that is already on the device.
        Returns the loss as a device scalar; nothing is read back."""
        a = self.args
        self.model.zero_grad(set_to_none=True)
        loss, _ = self.model(batch, targets=batch, training=True, compute_metrics=False,
                             generator=self._generator)
        loss.backward()
        if a.max_grad_norm and a.max_grad_norm > 0:
            clip_by_global_norm_(
                (p.grad for p in self.model.parameters() if p.grad is not None),
                a.max_grad_norm,
            )
        for group in self.optimizers["dense"].param_groups:
            group["lr"] = self._schedule(self._opt_step)
        for opt in self.optimizers.values():
            opt.step()
        self._opt_step += 1
        return loss.detach()

    # ------------------------------------------------------------------ train
    def train(self, resume_from_checkpoint=None) -> Dict[str, float]:
        """Train for ``num_training_steps``. ``resume_from_checkpoint``
        (``True``: the latest ``checkpoint-*`` under ``output_dir``; a string:
        that path) continues the original schedule and, with ``max_steps``
        set, runs only the remaining steps."""
        a = self.args
        loader = self.get_train_dataloader()
        num_steps = self.num_training_steps(loader)
        if not self.optimizers:
            self.create_optimizer_and_scheduler(num_steps)
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
                n_examples += next(iter(b.values())).shape[0]
                if (a.logging_steps and step_in_run % a.logging_steps == 0) \
                        or step_in_run == num_steps:
                    self.state.log_history.append(
                        {"loss": float(step_losses[i]), "step": self.state.global_step}
                    )
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
                pending.append(batch)
                # a group never crosses the run's end, a save or an evaluation
                # boundary: both must see the state exactly at that step
                k_target = min(K, num_steps - step_in_run)
                for every in (a.save_steps, a.eval_steps):
                    if every:
                        k_target = min(k_target, every - (step_in_run % every))
                if len(pending) < k_target:
                    continue
                dispatch(pending)
                pending = []
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

        runtime = time.time() - start
        metrics = {
            "train_loss": float(loss_sum) / step_in_run if step_in_run else float("nan"),
            "train_runtime": runtime,
            "train_samples_per_second": n_examples / max(runtime, 1e-9),
            "train_steps": step_in_run,
            "global_step": self.state.global_step,
        }
        self.state.log_history.append(metrics)
        return metrics

    # --------------------------------------------------------------- evaluate
    def _has_eval_data(self) -> bool:
        return (self._eval_dataloader is not None or self.eval_dataset is not None
                or self.schema is not None)

    def evaluate(self, eval_dataset=None, metric_key_prefix: str = "eval") -> Dict[str, float]:
        """``Model.evaluate`` over the evaluation loader; the result is also
        appended to ``state.log_history`` with the global step."""
        results = self.model.evaluate(self.get_eval_dataloader(eval_dataset),
                                      mode=metric_key_prefix,
                                      max_sequence_length=self.args.max_sequence_length)
        self.state.log_history.append({**results, "step": self.state.global_step})
        return results

    def predict(self, *args, **kwargs):
        raise NotImplementedError("Trainer.predict is not ported yet")

    def log_predictions(self, *args, **kwargs):
        raise NotImplementedError("Trainer.log_predictions is not ported yet")

    # ------------------------------------------------------------ checkpoints
    def _latest_checkpoint(self) -> Optional[str]:
        root = self.args.output_dir
        if not os.path.isdir(root):
            return None
        done = [(int(d.split("-")[1]), d) for d in os.listdir(root)
                if d.startswith("checkpoint-") and d.split("-")[1].isdigit()
                and os.path.isfile(os.path.join(root, d, CHECKPOINT_FILE))]
        return os.path.join(root, max(done)[1]) if done else None

    def _save_checkpoint(self) -> str:
        path = os.path.join(self.args.output_dir, f"checkpoint-{self.state.global_step}")
        self.save(path)
        return path

    def save(self, path: str) -> None:
        """Write the model, the optimizers, the trainer state, the generator
        and the loader position to ``path/trainer.pt`` (written under another
        name first, so a complete file is the completion marker)."""
        os.makedirs(path, exist_ok=True)
        doc = {
            "model": self.model.state_dict(),
            "optimizers": {k: opt.state_dict() for k, opt in self.optimizers.items()},
            "trainer_state": dataclasses.asdict(self.state),
            "opt_step": self._opt_step,
            "num_training_steps": self._last_num_steps,
            "generator": self._generator.get_state(),
        }
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        torch.save(doc, tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))

    def load(self, path: str) -> None:
        doc = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=self.device,
                         weights_only=False)
        self.model.load_state_dict(doc["model"])
        if doc["optimizers"]:
            self.create_optimizer_and_scheduler(doc["num_training_steps"])
            for k, sd in doc["optimizers"].items():
                self.optimizers[k].load_state_dict(sd)
        self._opt_step = doc["opt_step"]
        self.state = TrainerState(**doc["trainer_state"])
        self._generator.set_state(doc["generator"].cpu())
        self._resume_position = (self.state.loader_epoch, self.state.batches_in_epoch)
