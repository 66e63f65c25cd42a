"""Head / Model: body + prediction tasks.

Counterpart of ``transformers4rec_tpu/model/base.py``. ``Model`` is an
``nn.Module`` that holds its weights: it is initialised from a seed when it
is built and placed on its device (CUDA unless ``device="cpu"``).
``Model.evaluate`` streams batches through the fused evaluation path and
returns ``{"eval_loss": ..., "eval_/next-item/ndcg_at_10": ..., ...}``.
Training is ``loss, outputs = model(batch, training=True, generator=g)``:
the explicit flag selects the masking's training branch and dropout, whose
draws come from ``g``. ``masking_info=`` gives a ready mask, and
``sparse_rows=`` (``ops.sparse_update.GatheredRows``, from the sparse
embedding step) the tied table's rows gathered outside autograd: the item
lookup and the sampled softmax read them, the table takes no gradient. ``trainer.Trainer`` runs the loop, and ``Model.fit``
is the loop without a Trainer. ``Model.save`` / ``Model.load`` write and
read the state dict and the input schema (the layout of
``serving.export``'s artifact).

``Head.from_body(extra_blocks=...)`` puts blocks (``MLPBlock``) between
the input module and the transformer; each one without layers yet is
built for the width of the block before it.

A head holds any mix of tasks: ``NextItemPredictionTask`` and the dense
``BinaryClassificationTask`` and ``RegressionTask``, weighted by
``task_weights`` (``Head.from_schema`` builds one dense task for each
target column a schema tags). A dense task reads its targets from
``targets[target_name]`` (a dict, as the trainer passes the batch) or
``inputs[target_name]``; a model of several heads weighs them by
``head_weights``, in training as in ``Model.evaluate``. Inference returns
the next-item task's scores or top-k, or ``{task_name: predictions}`` for a
head without one.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..blocks.base import SequentialBlock, TransformerBlock
from ..config.transformer import T4RecConfig
from ..masking import MaskedLanguageModeling, MaskingInfo, masking_registry
from ..ops.sparse_update import GatheredRows
from ..schema import ColumnSchema, Schema, Tags, ValueCount
from ..utils.device import disable_tf32, module_device, resolve_device
from .prediction_task import (
    BinaryClassificationTask,
    NextItemPredictionTask,
    RegressionTask,
    TaskOutput,
)


def load_weights(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """``module.load_state_dict(state)`` (strict), each parameter first given
    the floating type its entry in ``state`` has: a bf16-stored table comes
    back bf16 (never copied into an f32 parameter), an f32 one f32."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            t = state.get(name)
            if t is not None and t.is_floating_point() and t.dtype != p.dtype:
                p.data = p.data.to(t.dtype)
    module.load_state_dict(state)


def task_loss_state(outs: Dict[str, TaskOutput]) -> Dict[str, tuple]:
    """Per-task (weighted-loss-sum, weight-sum): the sufficient statistics of
    a dataset-level weighted-mean loss."""
    state = {}
    for task_name, out in outs.items():
        w = out.loss_weight
        w = torch.ones((), device=out.loss.device) if w is None else w.clamp_min(0.0)
        state[task_name] = (out.loss * w, w)
    return state


def merge_loss_state(state: Dict[str, tuple], new: Dict[str, tuple]):
    if not state:
        return new
    return {name: (state[name][0] + s, state[name][1] + w) for name, (s, w) in new.items()}


def task_loss_coefficients(model) -> Dict[str, float]:
    """Each task's weight in the loss ``Model.forward`` returns: its head's
    weight over the heads' sum times its own over its head's tasks' sum."""
    heads = list(model.heads)
    hw = list(model.head_weights or [1.0] * len(heads))
    coefs = {}
    for w_h, head in zip(hw, heads):
        tasks = list(head.tasks)
        tw = list(head.task_weights or [1.0] * len(tasks))
        for w_t, t in zip(tw, tasks):
            coefs[t.task_name] = w_h / max(sum(hw), 1e-9) * w_t / max(sum(tw), 1e-9)
    return coefs


def combine_task_losses(model, task_means: Dict[str, float]) -> float:
    """Recombine per-task dataset-level mean losses with the head and task
    weights ``Model.forward`` applies per batch."""
    return float(sum(c * task_means.get(name, 0.0)
                     for name, c in task_loss_coefficients(model).items()))


def _all_reduce_states(states: List[Dict[str, tuple]], group) -> List[Dict[str, tuple]]:
    """Every (sum, count) tensor of ``states`` summed over ``group``, in one
    collective."""
    flat = [(i, name, j, t) for i, state in enumerate(states)
            for name, pair in state.items() for j, t in enumerate(pair)]
    if not flat:
        return states
    buf = torch.cat([t.detach().float().reshape(-1) for *_, t in flat])
    torch.distributed.all_reduce(buf, group=group)
    out = [{name: list(pair) for name, pair in state.items()} for state in states]
    offset = 0
    for i, name, j, t in flat:
        out[i][name][j] = buf[offset:offset + t.numel()].view(t.shape)
        offset += t.numel()
    return [{name: tuple(pair) for name, pair in state.items()} for state in out]


class Head(nn.Module):
    """One body + one or more prediction tasks."""

    def __init__(self, body: SequentialBlock, tasks: Sequence[nn.Module],
                 task_weights: Optional[Sequence[float]] = None):
        super().__init__()
        self.body = body
        self.tasks = nn.ModuleList(tasks)
        self.task_weights = list(task_weights) if task_weights is not None else None

    @classmethod
    def from_body(
        cls,
        input_module,
        transformer: Optional[T4RecConfig] = None,
        tasks: Optional[Sequence[Any]] = None,
        task_weights: Optional[Sequence[float]] = None,
        extra_blocks: Sequence[Any] = (),
    ) -> "Head":
        """Wire the input module + transformer into a body and configure a
        copy of each task (the task objects given stay as they were): a
        NextItemPredictionTask from the masking scheme and the schema, every
        task built for the body's width."""
        blocks: List[Any] = [input_module]
        for block in extra_blocks:
            if getattr(block, "input_dim", 0) is None:
                block.build(blocks[-1].output_size())
            blocks.append(block)
        masking = getattr(input_module, "masking", None)
        # the scheme's registry name, for the arch compat check
        masking_name = next((key for key in ("clm", "mlm", "plm", "rtd")
                             if masking is not None
                             and masking_registry.get(key) is type(masking)), None)
        if transformer is not None:
            blocks.append(TransformerBlock(transformer, masking=masking_name))
        body = SequentialBlock(blocks)

        configured = []
        for t in tasks or [NextItemPredictionTask(weight_tying=True)]:
            t = copy.deepcopy(t)
            if not isinstance(t, NextItemPredictionTask):
                t.build(body.output_size())
                configured.append(t)
                continue
            if t.target_dim is None:
                # true item vocab (tables may carry padding rows)
                schema_ = getattr(input_module, "schema", None)
                item_col = getattr(input_module, "item_id", None)
                if schema_ is not None and item_col is not None:
                    t.target_dim = schema_.categorical_cardinalities().get(item_col)
            if masking is not None:
                if (t.loss_budget is None and t.budget_target_prob is None
                        and isinstance(masking, MaskedLanguageModeling)):
                    # adaptive loss budget: a ≥6σ binomial bound on the target
                    # count (NextItemPredictionTask._budget_rows)
                    t.budget_target_prob = float(masking.mlm_probability)
                t.eval_single_target = bool(getattr(masking, "eval_on_last_item_seq_only", True))
                t.padding_idx = getattr(masking, "padding_idx", 0)
            item_dim = input_module.item_embedding_table().shape[-1] if t.weight_tying else None
            t.build(body.output_size(), item_dim)
            configured.append(t)
        return cls(body=body, tasks=configured, task_weights=task_weights)

    @classmethod
    def from_schema(cls, schema: Schema, body: SequentialBlock,
                    task_weights: Optional[Sequence[float]] = None) -> "Head":
        """A binary task for each column tagged binary classification (a
        target that is not continuous), a regression task for each column
        tagged regression, each named after its column and built for the
        body's width."""
        tasks: List[nn.Module] = []
        for col in schema.select_by_tag([Tags.BINARY_CLASSIFICATION, Tags.TARGET]):
            if col.has_tag(Tags.REGRESSION) or (
                    col.is_continuous and not col.has_tag(Tags.BINARY_CLASSIFICATION)):
                continue
            tasks.append(BinaryClassificationTask(target_name=col.name, task_name=col.name))
        for col in schema.select_by_tag([Tags.REGRESSION]):
            tasks.append(RegressionTask(target_name=col.name, task_name=col.name))
        if not tasks:
            raise ValueError("No target columns found in schema")
        for t in tasks:
            t.build(body.output_size())
        return cls(body=body, tasks=tasks, task_weights=task_weights)

    @property
    def input_module(self):
        return self.body.blocks[0]

    def forward(self, inputs: Dict[str, torch.Tensor], targets=None, training: bool = False,
                testing: bool = False, top_k: Optional[int] = None,
                compute_metrics: bool = True,
                generator: Optional[torch.Generator] = None,
                masking_info: Optional[MaskingInfo] = None,
                sparse_rows: Optional[GatheredRows] = None):
        pad_mask = None
        item_id = getattr(self.input_module, "item_id", None)
        if item_id is not None and item_id in inputs:
            pad_mask = inputs[item_id] != getattr(self.input_module, "padding_idx", 0)
        hidden, info = self.body(inputs, training=training, testing=testing, pad_mask=pad_mask,
                                 generator=generator, masking_info=masking_info,
                                 sparse_rows=sparse_rows)

        weights = list(self.task_weights or [1.0] * len(self.tasks))
        outputs: Dict[str, TaskOutput] = {}
        total_loss = torch.zeros((), device=hidden.device)
        inference_out = None
        for w, task in zip(weights, self.tasks):
            if isinstance(task, NextItemPredictionTask):
                out = task(hidden, info, training=training, testing=testing, top_k=top_k,
                           compute_metrics=compute_metrics, generator=generator,
                           sparse_rows=sparse_rows)
            else:
                t = targets
                if isinstance(targets, dict):
                    t = targets.get(task.target_name or task.task_name)
                elif task.target_name and task.target_name in inputs:
                    t = inputs[task.target_name]
                out = task(hidden, targets=t, pad_mask=pad_mask, training=training,
                           testing=testing)
            if isinstance(out, TaskOutput):
                outputs[task.task_name] = out
                total_loss = total_loss + w * out.loss
            else:
                inference_out = out  # scores, or (scores, ids) with top_k
        if not (training or testing):
            if inference_out is not None:
                return inference_out
            return {name: o.predictions for name, o in outputs.items()}
        return total_loss / sum(weights), outputs


class Model(nn.Module):
    """Multi-head model. Inference: ``model(batch, top_k=k)`` → next-item
    scores, or ``(scores, ids)``. Evaluation: ``model(batch, testing=True)``
    → ``(loss, {task: TaskOutput})``, or ``model.evaluate(loader)``.
    Training: ``model(batch, training=True, generator=g)`` → the same pair,
    with the mask and dropout drawn from ``g`` (a ``torch.Generator`` on the
    model's device), or the mask given as ``masking_info``."""

    def __init__(self, heads: Sequence[Head], head_weights: Optional[Sequence[float]] = None,
                 top_k: Optional[int] = None, device=None, seed: int = 0):
        super().__init__()
        self.heads = nn.ModuleList(heads)
        self.head_weights = list(head_weights) if head_weights is not None else None
        if self.head_weights is not None and len(self.head_weights) != len(self.heads):
            raise ValueError(
                f"head_weights must match the number of heads ({len(self.head_weights)} "
                f"weights for {len(self.heads)} heads)"
            )
        self.top_k = top_k
        dev = resolve_device(device)
        # f32 products stay f32 on the GPU: the reference scores in f32 x f32
        disable_tf32()
        for head in self.heads:
            # a vocab-parallel task scores against this rank's rows of the tied table
            for task in head.tasks:
                group = getattr(task, "vocab_parallel_group", None)
                tables = head.input_module.categorical_module
                if group is not None and head.input_module.item_id not in tables.table_groups:
                    tables.shard_table(head.input_module.item_id, group)
        self.reset_parameters(seed)
        self.to(dev)
        self.eval()

    def reset_parameters(self, seed: int = 0) -> None:
        """Initialise every weight from ``seed`` with the JAX package's
        initialisers (same distributions; the draws differ)."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for module in self.modules():
                init = getattr(module, "_init_weights", None)
                if init is not None:
                    init(gen)

    @property
    def device(self) -> torch.device:
        return module_device(self)

    def forward(self, inputs: Dict[str, torch.Tensor], targets=None, training: bool = False,
                testing: bool = False, top_k: Optional[int] = None,
                compute_metrics: bool = True,
                generator: Optional[torch.Generator] = None,
                masking_info: Optional[MaskingInfo] = None,
                sparse_rows: Optional[GatheredRows] = None):
        top_k = top_k if top_k is not None else self.top_k
        if not (training or testing):
            if len(self.heads) == 1:
                return self.heads[0](inputs, top_k=top_k)
            return [h(inputs, top_k=top_k) for h in self.heads]
        weights = list(self.head_weights or [1.0] * len(self.heads))
        total = torch.zeros((), device=self.device)
        all_outputs: Dict[str, TaskOutput] = {}
        for w, head in zip(weights, self.heads):
            loss, outs = head(inputs, targets=targets, training=training, testing=testing,
                              compute_metrics=compute_metrics, generator=generator,
                              masking_info=masking_info, sparse_rows=sparse_rows)
            total = total + w * loss
            all_outputs.update(outs)
        return total / sum(weights), all_outputs

    # ------------------------------------------------------------ evaluation
    def _as_dense(self, batch, max_sequence_length=None,
                  non_blocking: bool = False) -> Dict[str, torch.Tensor]:
        """Host-side model-entry densify (ragged ``__values``/``__offsets``
        columns pad to ``max_sequence_length``), then move to the device.
        ``non_blocking`` copies from pinned memory without waiting for the
        device's queue (the training loop's group of steps)."""
        if any(k.endswith("__offsets") for k in batch):
            from ..data.padding import pad_inputs

            batch = pad_inputs({k: np.asarray(v) for k, v in batch.items()},
                               max_sequence_length)
        dev = self.device
        out = {}
        for k, v in batch.items():
            if not torch.is_tensor(v):
                v = np.asarray(v)
                # the model reads continuous features in float32: Parquet's
                # float64 columns are narrowed before the copy
                v = v.astype(np.float32) if v.dtype == np.float64 else v
            t = torch.as_tensor(v)
            if non_blocking and dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(dev, non_blocking=non_blocking)
        return out

    @staticmethod
    def _ragged_max_len(batch) -> Optional[int]:
        out = None
        for k, v in batch.items():
            if k.endswith("__offsets"):
                off = np.asarray(v)
                if len(off) > 1:
                    out = max(out or 0, int((off[1:] - off[:-1]).max()))
        return out

    def evaluate(self, dataloader, mode: str = "eval", max_steps: Optional[int] = None,
                 max_sequence_length: Optional[int] = None,
                 compute_metrics_each_n_steps: int = 1,
                 data_group=None) -> Dict[str, float]:
        """Stream batches, accumulate (sum, count) metric states on the
        device, return flattened ``{mode_/task/metric_at_k: value}`` plus
        ``{mode}_loss``. The metrics are updated on every
        ``compute_metrics_each_n_steps``-th batch, the loss on all. With a
        ``data_group`` (data parallelism: each rank evaluates its stripe of
        the data) the states are summed over the group once, before the
        division."""
        from .ranking_metric import finalize_metrics, update_metric_state

        metric_state: Dict[str, Any] = {}
        loss_state: Dict[str, Any] = {}
        with torch.inference_mode():
            for i, batch in enumerate(dataloader):
                if max_steps is not None and i >= max_steps:
                    break
                if max_sequence_length is None:
                    max_sequence_length = self._ragged_max_len(batch)
                batch = self._as_dense(batch, max_sequence_length)
                with_metrics = i % compute_metrics_each_n_steps == 0
                _, outs = self(batch, targets=batch, testing=True, compute_metrics=with_metrics)
                loss_state = merge_loss_state(loss_state, task_loss_state(outs))
                if not with_metrics:
                    continue
                metrics = {
                    f"{task_name}/{k}": v
                    for task_name, out in outs.items() if out.metrics
                    for k, v in out.metrics.items()
                }
                metric_state = (update_metric_state(metric_state, metrics)
                                if metric_state else metrics)
        if data_group is not None:
            loss_state, metric_state = _all_reduce_states([loss_state, metric_state],
                                                          data_group)
        task_means = {name: float(s) / max(float(w), 1.0) for name, (s, w) in loss_state.items()}
        results = {f"{mode}_loss": combine_task_losses(self, task_means)}
        for name, val in finalize_metrics(metric_state).items():
            results[f"{mode}_/{name}"] = float(val)
        return results

    # ------------------------------------------------------- the loop alone
    def fit(self, dataloader, optimizer: Optional[torch.optim.Optimizer] = None,
            num_epochs: int = 1, max_steps: Optional[int] = None,
            max_sequence_length: Optional[int] = None,
            generator: Optional[torch.Generator] = None,
            verbose: bool = False) -> List[float]:
        """Train on ``dataloader`` without a ``Trainer``: ``num_epochs``
        passes, or ``max_steps`` steps. The model's own parameters are
        updated in place (the JAX package's ``fit`` returns new parameters
        instead). ``optimizer`` defaults to ``torch.optim.Adam(lr=1e-3)``
        over every parameter, the reference's default; the mask and dropout
        are drawn from ``generator`` (seeded with 0 when not given, as the
        JAX ``fit``'s default key). Returns the loss of every step."""
        optimizer = optimizer or torch.optim.Adam(self.parameters(), lr=1e-3)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        losses: List[torch.Tensor] = []
        for epoch in range(num_epochs):
            for batch in dataloader:
                if max_sequence_length is None:
                    max_sequence_length = self._ragged_max_len(batch)
                b = self._as_dense(batch, max_sequence_length)
                optimizer.zero_grad(set_to_none=True)
                loss, _ = self(b, targets=b, training=True, compute_metrics=False,
                               generator=generator)
                loss.backward()
                optimizer.step()
                losses.append(loss.detach())
                if max_steps is not None and len(losses) >= max_steps:
                    break
            if verbose and losses:
                print(f"[epoch {epoch}] loss {float(losses[-1]):.5f}")
            if max_steps is not None and len(losses) >= max_steps:
                break
        # one read of the losses at the end: no synchronisation per step
        return torch.stack(losses).tolist() if losses else []

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Write the state dict (``model.pt``, CPU tensors) and
        ``input_schema.json`` to the directory ``path``; the architecture
        is rebuilt by the caller."""
        os.makedirs(path, exist_ok=True)
        state = {k: v.detach().cpu() for k, v in self.state_dict().items()}
        torch.save(state, os.path.join(path, "model.pt"))
        self.input_schema.to_json_file(os.path.join(path, "input_schema.json"))

    def load(self, path: str) -> "Model":
        """Restore the weights ``save`` wrote into this model, on its
        device, each in the type it was saved in (``load_weights``)."""
        state = torch.load(os.path.join(path, "model.pt"), map_location=self.device,
                           weights_only=True)
        load_weights(self, state)
        return self

    # ------------------------------------------------------------ serving I/O
    @property
    def input_schema(self) -> Schema:
        """Feature columns consumed at inference."""
        cols: List[ColumnSchema] = []
        seen = set()
        for head in self.heads:
            schema = getattr(head.input_module, "schema", None)
            if schema is None:
                continue
            for col in schema:
                if col.name not in seen:
                    seen.add(col.name)
                    cols.append(col)
        return Schema(cols)

    def output_schema_for(self, top_k: Optional[int]) -> Schema:
        """Scores (+ ids when ``top_k`` is set) of the first head's first
        task; a dense task's predictions under its name."""
        task = self.heads[0].tasks[0]
        if not isinstance(task, NextItemPredictionTask):
            return Schema([ColumnSchema(task.task_name, type=3)])
        if top_k is not None:
            return Schema([
                ColumnSchema("item_id_scores", type=3,
                             value_count=ValueCount(top_k, top_k)),
                ColumnSchema("item_ids", type=2, value_count=ValueCount(top_k, top_k)),
            ])
        return Schema([ColumnSchema("next-item", type=3)])
