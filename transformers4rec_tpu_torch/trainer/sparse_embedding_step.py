"""The O(N·E) sparse-embedding training step: the item table never takes a
dense (V, E) gradient.

Counterpart of ``transformers4rec_tpu/trainer/sparse_embedding_step.py``
(``embedding_optimizer="sparse_adam"`` or ``"sparse_adafactor"``). A
sampled-softmax step knows every table row it touches before the model
runs: the item ids of the batch (and, under swap noise, the swapped ids)
and the negatives, which the step draws itself from the trainer's
generator and passes as the batch key ``__neg_ids__``. The labels are batch
ids at known positions (MLM and PLM: the same position; CLM: the next one).
So the step:

1. gathers ``rows = table[all_ids]`` under ``torch.no_grad()`` and makes
   them a leaf that takes the gradient (``GatheredRows``);
2. runs the model with ``sparse_rows=``: the item lookup reads
   ``rows[:n_in]`` and the sampled softmax ``rows[pos_map]`` and
   ``rows[neg_base:]``, so the loss and every gradient are the dense path's
   and the table's ``.grad`` stays ``None``;
3. sums the row gradients of repeated ids (``dedupe_row_grads``), clips
   the joint global norm of the dense gradients and those sums (the dense
   path's clip sees duplicate rows summed in dW), and moves only the touched
   rows (``sparse_rows_adam_update`` or ``sparse_rows_adafactor_update``).

Row layout: ``[lookup rows (B·S) | label rows (B·S, under swap noise only) |
negatives (n)]``. Swap noise (the one ``pre`` transformation that composes)
is drawn here, before the gather, from the same generator: the lookup reads
the swapped ids while the labels stay the batch's. The draws of a step come
in this order: the negatives, the swap noise, then the model's (the mask,
dropout).

Gradient accumulation over K micro-steps (``SparseAccumState``): the dense
gradients sum in their ``.grad``; each micro-step's ids and row gradients
are kept, and at the boundary their concatenation (the gradients divided by
K) is deduplicated once, clipped jointly with the dense mean, and applied
once: ``optax.MultiSteps(chain(clip, tx))`` semantics without a (V, E)
buffer.

Over ranks (the JAX step does the same on global arrays): with the item
table row-sharded over its task's model group, the rows are gathered
through ``parallel.sharded_embedding_lookup`` (each rank its own rows, one sum
over the group), so every rank of the group holds them all and takes the
same gradients; each rank then moves only the rows it owns
(``sharded_rows_adam_update``, ``sharded_rows_adafactor_update``). Over a
data axis the ids and row gradients of every data row are gathered before
the deduplication, so the sums of repeated ids cover the global batch.

Refused (``validate_sparse_config``): more than one head, or other than one
``NextItemPredictionTask``; a full softmax or an untied output (the loss
would touch every row); a ``pre`` other than ``StochasticSwapNoise``; a
frozen item table; RTD (its discriminator looks up ids drawn inside the
model).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.sparse_update import (
    GatheredRows,
    dedupe_row_grads,
    sharded_rows_adafactor_update,
    sharded_rows_adam_update,
    sparse_rows_adafactor_init,
    sparse_rows_adafactor_update,
    sparse_rows_adam_init,
    sparse_rows_adam_update,
)
from ..parallel.mesh import all_gather_rows, all_reduce_, group_size
from ..parallel.sharded_embedding import sharded_embedding_lookup
from .arguments import SPARSE_OPTIMIZERS

__all__ = ["SPARSE_OPTIMIZERS", "SparseAccumState", "SparseEmbeddingStep", "gather_rows",
           "sparse_accum_init", "validate_sparse_config"]


@dataclasses.dataclass
class SparseAccumState:
    """The sparse step's accumulation carry between optimizer updates: each
    micro-step's touched ids and row gradients (f32), one entry a micro-step
    since the last update. The dense gradients sum in the parameters'
    ``.grad``."""

    ids: List[torch.Tensor] = dataclasses.field(default_factory=list)
    grads: List[torch.Tensor] = dataclasses.field(default_factory=list)


def sparse_accum_init() -> SparseAccumState:
    return SparseAccumState()


def validate_sparse_config(model) -> Tuple[object, str, str]:
    """Check that ``model`` has the shape the sparse step supports; returns
    ``(task, item_col, masking_name)``."""
    from ..masking import masking_registry
    from ..model.prediction_task import NextItemPredictionTask
    from ..tabular.transformations import StochasticSwapNoise

    heads = list(getattr(model, "heads", ()) or ())
    tasks = [t for h in heads for t in h.tasks if isinstance(t, NextItemPredictionTask)]
    if len(heads) != 1 or len(tasks) != 1:
        raise NotImplementedError(
            "sparse_adam requires exactly one head with one NextItemPredictionTask")
    task = tasks[0]
    if not (task.sampled_softmax and task.weight_tying):
        raise NotImplementedError(
            "sparse_adam requires sampled_softmax=True and weight_tying=True "
            "(a full-softmax loss touches every table row — use the fused/"
            "vocab-parallel CE with 'adafactor' instead)")
    im = heads[0].input_module
    item_col = getattr(im, "item_id", None)
    if item_col is None:
        raise ValueError("sparse_adam: input module has no item_id column")
    pre = [getattr(im, name) for name in getattr(im, "_pre_names", ())]
    if pre and not (len(pre) == 1 and isinstance(pre[0], StochasticSwapNoise)):
        # an id-rewriting transformation changes which rows a batch touches:
        # swap noise is drawn by the step itself before the gather
        raise NotImplementedError(
            "sparse embedding optimizers compose with StochasticSwapNoise as the only "
            f"input PRE transformation (got {pre!r}): the touched-row set must be "
            "derivable trainer-side before the model runs")
    if not im.item_embedding_table().requires_grad:
        # the sparse update would thaw a table the dense paths keep frozen
        raise NotImplementedError(
            "sparse_adam cannot update a frozen (trainable=False) pretrained item table "
            "— use a dense embedding_optimizer")
    masking = getattr(im, "masking", None)
    masking_name = next((key for key in ("clm", "mlm", "plm", "rtd")
                         if masking is not None and masking_registry.get(key) is type(masking)),
                        None)
    if masking_name not in ("mlm", "clm", "plm"):
        raise NotImplementedError(
            f"sparse embedding optimizers support mlm/clm/plm masking (got {masking_name!r}): "
            "RTD's corrupted-input lookup reads rows sampled inside the model, so they cannot "
            "be pre-gathered")
    return task, item_col, masking_name


def _pos_map(masking_name: str, B: int, S: int, device=None) -> torch.Tensor:
    """The row (into the lookup rows) of each position's label, made on
    ``device``: MLM and PLM label a position with its own id, CLM with the
    next position's (the last column has no target, weight 0, so its
    clipped entry is never read with a nonzero weight)."""
    if masking_name in ("mlm", "plm"):
        return torch.arange(B * S, device=device)
    cols = torch.clamp(torch.arange(S, device=device) + 1, max=S - 1)
    return (torch.arange(B, device=device)[:, None] * S + cols[None, :]).reshape(-1)


def gather_rows(table: torch.Tensor, item_ids: torch.Tensor, neg_ids: torch.Tensor,
                masking_name: str, aug_inputs=None, item_col: str = "item_id",
                group=None) -> Tuple[GatheredRows, torch.Tensor]:
    """The rows of ``table`` a step touches, gathered under
    ``torch.no_grad()`` into a leaf that takes the gradient, and their ids:
    the lookup ids (the swapped ones of ``aug_inputs[item_col]`` under swap
    noise), the label ids (a region of their own under swap noise) and the
    negatives. With ``group``, ``table`` is this rank's shard of a table
    row-sharded over it."""
    B, S = item_ids.shape
    n_in = B * S
    ids_in = item_ids.reshape(-1).long()
    neg_ids = neg_ids.to(ids_in.device).long()
    pos_map = _pos_map(masking_name, B, S, ids_in.device)
    if aug_inputs is not None:
        parts = [aug_inputs[item_col].reshape(-1).long(), ids_in, neg_ids]
        pos_map, neg_base = pos_map + n_in, 2 * n_in
    else:
        parts, neg_base = [ids_in, neg_ids], n_in
    all_ids = torch.cat(parts)
    with torch.no_grad():
        rows = (table.index_select(0, all_ids) if group is None
                else sharded_embedding_lookup(table, all_ids, group))
    rows.requires_grad_()
    return GatheredRows(rows=rows, n_in=n_in, pos_map=pos_map, neg_base=neg_base,
                        neg_ids=neg_ids, aug_inputs=aug_inputs), all_ids


class SparseEmbeddingStep:
    """The item table's side of the sparse arm: ``forward_backward`` runs one
    micro-step (forward and backward with gathered rows, the row gradients
    kept), ``apply`` closes an optimizer update (dedupe, joint clip, the
    touched rows' update). ``state`` is the rows' optimizer state
    (``SparseRowsAdamState`` or ``SparseRowsAdafactorState``), ``accum`` the
    accumulation carry; the trainer checkpoints both."""

    def __init__(self, model, args, rule: str = "adam", data_group=None):
        task, self.item_col, self.masking_name = validate_sparse_config(model)
        self.model, self.args, self.rule = model, args, rule
        im = model.heads[0].input_module
        self.table = im.item_embedding_table()
        # the model group over which the table is row-sharded, and the data group
        self.group, self.data_group = task.vocab_parallel_group, data_group
        self.shards = group_size(self.group)
        self.rows = self.table.shape[0] * self.shards  # of the whole table
        self.lo = (0 if self.group is None
                   else torch.distributed.get_rank(self.group) * self.table.shape[0])
        self.sampler = task.make_sampler(self.rows)
        self.swap_noise = getattr(im, im._pre_names[0]) if im._pre_names else None
        self.padding_idx = im.padding_idx
        mdt = torch.bfloat16 if args.embedding_moment_dtype == "bf16" else None
        init = sparse_rows_adafactor_init if rule == "adafactor" else sparse_rows_adam_init
        self.state = init(self.table.detach(), moment_dtype=mdt)
        self.accum = sparse_accum_init()

    def gather(self, batch, generator: Optional[torch.Generator],
               neg_ids: Optional[torch.Tensor] = None
               ) -> Tuple[GatheredRows, torch.Tensor, dict]:
        """Draw the negatives (unless ``neg_ids`` gives them), then the swap
        noise, from ``generator`` and gather their rows and the batch's
        (``gather_rows``): ``(rows, their ids, the batch with
        __neg_ids__)``."""
        item_ids = batch[self.item_col].long()
        neg = (self.sampler.sample(generator, device=item_ids.device) if neg_ids is None
               else neg_ids.to(item_ids.device).long())
        aug = None
        if self.swap_noise is not None:
            aug = self.swap_noise(batch, training=True, pad_mask=item_ids != self.padding_idx,
                                  generator=generator)
        rows, ids = gather_rows(self.table, item_ids, neg, self.masking_name,
                                aug_inputs=aug, item_col=self.item_col, group=self.group)
        return rows, ids, {**batch, "__neg_ids__": neg}

    def forward_backward(self, batch, generator: Optional[torch.Generator],
                         masking_info=None, backward=None) -> torch.Tensor:
        """One micro-step: the loss (a device scalar) after its backward;
        the dense gradients add to ``.grad``, the rows' are kept. A ready
        ``masking_info`` replaces the mask's draw, and its ``neg_ids`` the
        negatives' (two devices given one draw). ``backward(loss, outputs)``
        (the trainer's, which takes the data axis's global mean) replaces
        ``loss.backward()`` and returns the loss's value."""
        neg = None if masking_info is None else masking_info.neg_ids
        rows, ids, batch2 = self.gather(batch, generator, neg_ids=neg)
        loss, outs = self.model(batch2, targets=batch2, training=True, compute_metrics=False,
                                generator=generator, masking_info=masking_info,
                                sparse_rows=rows)
        if backward is None:
            loss.backward()
            loss = loss.detach()
        else:
            loss = backward(loss, outs)
        self.accum.ids.append(ids)
        self.accum.grads.append(rows.rows.grad.float())
        return loss

    def apply(self, dense_grads: Sequence[torch.Tensor], lr: float, k: int = 1,
              sharded: Sequence[torch.Tensor] = (), group=None) -> None:
        """Close an update over the ``k`` buffered micro-steps: the row
        gradients (each divided by ``k`` when ``k > 1``; every data row's,
        over a data axis) deduplicated once, the joint clip at
        ``args.max_grad_norm`` over them and the dense gradients (already
        the mean, scaled in place; ``sharded`` are row shards of other
        tables over ``group``, their squares summed over it), then the
        touched rows' update at ``lr``. The buffers empty."""
        ids = torch.cat(self.accum.ids)
        g = torch.cat(self.accum.grads)
        if k > 1:
            g = g / k
        self.accum = sparse_accum_init()
        ids, g = all_gather_rows(ids, self.data_group), all_gather_rows(g, self.data_group)
        uids, g_sum = dedupe_row_grads(ids, g, self.rows)
        clip = self.args.max_grad_norm
        if clip and clip > 0:
            # the global norm of every tensor's own norm, in a few launches
            # (one a tensor would make the host pace the step)
            grads = list(dense_grads)
            norms = torch.stack(torch._foreach_norm(grads + [g_sum]))
            if sharded:
                sq = all_reduce_(torch.stack(torch._foreach_norm(list(sharded))).square().sum(),
                                 group)
                gn = torch.sqrt(norms.square().sum() + sq)
                grads = grads + list(sharded)
            else:
                gn = torch.linalg.vector_norm(norms)
            scale = torch.clamp(clip / torch.clamp_min(gn, 1e-12), max=1.0)
            torch._foreach_mul_(grads, scale)
            g_sum = g_sum * scale
        a = self.args
        if self.group is not None:
            if self.rule == "adafactor":
                sharded_rows_adafactor_update(self.table.data, self.state, uids, g_sum, lr,
                                              self.lo, self.table.shape[0], self.group,
                                              self.rows, deduped=True)
            else:
                sharded_rows_adam_update(self.table.data, self.state, uids, g_sum, lr, self.lo,
                                         self.table.shape[0], b1=a.adam_beta1, b2=a.adam_beta2,
                                         eps=a.adam_epsilon, deduped=True)
        elif self.rule == "adafactor":
            sparse_rows_adafactor_update(self.table.data, self.state, uids, g_sum, lr,
                                         deduped=True)
        else:
            sparse_rows_adam_update(self.table.data, self.state, uids, g_sum, lr,
                                    b1=a.adam_beta1, b2=a.adam_beta2, eps=a.adam_epsilon,
                                    deduped=True)

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        # the tensors themselves (``dataclasses.asdict`` would copy them)
        return {"state": dict(vars(self.state)),
                "accum": {"ids": list(self.accum.ids), "grads": list(self.accum.grads)}}

    def load_state_dict(self, doc: dict) -> None:
        # copies: the updates work in place and must not reach ``doc``
        dev = self.table.device
        self.state = type(self.state)(**{k: v.to(dev, copy=True)
                                         for k, v in doc["state"].items()})
        acc = doc["accum"]
        self.accum = SparseAccumState(ids=[t.to(dev, copy=True) for t in acc["ids"]],
                                      grads=[t.to(dev, copy=True) for t in acc["grads"]])
