"""Masking / label generation: causal (CLM), masked (MLM) and permutation
(PLM) language modeling.

Counterpart of ``transformers4rec_tpu/masking.py``. Masking is pure label
generation: ``(embeds, item_ids, flags) → (masked_embeds, MaskingInfo)``;
nothing is stored on the module but the trainable [MASK] embedding.

Ported: ``MaskingInfo``, ``MaskSequence``, ``CausalLanguageModeling`` in
its three branches (training: shift-by-one labels, optionally only the last
one; testing: the label at the last target position or at every position;
inference: identity targets), ``MaskedLanguageModeling`` in its inference
branch (one [MASK] position appended at index ``len``), its testing branch
(the label at the last item, or shift-by-one labels at every position) and
its training branch (Bernoulli masking with the ≥1-masked / ≥1-unmasked
guarantee), and ``PermutationLanguageModeling`` (XLNet's scheme: spans of
masked items, a random factorisation order as ``perm_mask`` for the
two-stream encoder; in evaluation and inference the causal ``perm_mask``,
with the last item hidden from every query, or on every position) and
``ReplacementLanguageModeling`` (ELECTRA's RTD: MLM's masking, and the
helpers that build a discriminator's corrupted inputs and labels from a
generator's logits or from the batch's own ids). Random
draws come from an explicit ``torch.Generator`` on the tensors' device; a
caller may instead hand ``MaskSequence.forward`` a ready ``MaskingInfo``
(``masking_info=``), which skips the draw: that is how two devices, or two
packages, are given the same mask. The RTD helpers take a generator, or
the draw itself, the same way. Not ported yet (raises
``NotImplementedError``): session packing (``segment_ids``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .utils.registry import Registry

masking_registry: Registry = Registry("masking")


@dataclasses.dataclass
class MaskingInfo:
    """Everything downstream consumers need, threaded as values.

    targets: (B, S') long — label item ids (padding_idx where no target).
    mask:    (B, S') bool — True at positions that carry a target.
    input_schema: (B, S') bool — positions replaced by the [MASK] embedding.
    perm_mask: (B, S, S) float, PLM only — 1 where query i must NOT attend
        key j.
    pad_mask: (B, S') bool — True at real (non-pad) positions of the
        post-masking sequence; S' = S+1 under the MLM inference extension.
    item_ids / item_table: the raw item-id sequence and the tied item table,
        filled by TabularSequenceFeatures for the prediction head.
    neg_ids: (n,) long, optional — sampled-softmax negatives drawn outside
        the model; the task scores against them instead of its own draw.
    """

    targets: torch.Tensor
    mask: torch.Tensor
    input_schema: torch.Tensor
    perm_mask: Optional[torch.Tensor] = None
    pad_mask: Optional[torch.Tensor] = None
    item_ids: Optional[torch.Tensor] = None
    item_table: Optional[torch.Tensor] = None
    segment_ids: Optional[torch.Tensor] = None
    neg_ids: Optional[torch.Tensor] = None

    def replace(self, **kwargs) -> "MaskingInfo":
        return dataclasses.replace(self, **kwargs)


def _predict_all(item_ids: torch.Tensor, padding_idx: int):
    """Shift-by-one next-item labels: position i is labelled with item i + 1."""
    labels = torch.cat([item_ids[:, 1:], torch.zeros_like(item_ids[:, :1])], dim=1)
    if padding_idx != 0:
        labels[:, -1] = padding_idx
    return labels, labels != padding_idx


def _label_at_last(item_ids: torch.Tensor, non_pad: torch.Tensor, padding_idx: int):
    """Labels only at the last non-padded position."""
    last = (non_pad.sum(dim=1) - 1).clamp_min(0)
    onehot = torch.arange(item_ids.shape[1], device=item_ids.device)[None, :] == last[:, None]
    labels = torch.where(onehot, item_ids, torch.full_like(item_ids, padding_idx))
    return labels, labels != padding_idx


def _sample_index_from_mask(mask: torch.Tensor, generator) -> torch.Tensor:
    """One True index per row of a boolean (B, S) mask, uniformly (the
    Gumbel-max form of a categorical draw with equal logits)."""
    u = torch.rand(mask.shape, generator=generator, device=mask.device)
    return torch.where(mask, u, -1.0).argmax(dim=1)


def _ensure_min_masking(labels, mask_labels, item_ids, non_pad, padding_idx: int, generator):
    """Guarantee ≥1 masked and ≥1 unmasked item per session."""
    pos = torch.arange(item_ids.shape[1], device=item_ids.device)[None, :]
    # ≥1 masked: force one random non-pad position into the labels
    force = pos == _sample_index_from_mask(non_pad, generator)[:, None]
    needs_force = ~mask_labels.any(dim=1, keepdim=True)
    labels = torch.where(needs_force & force, item_ids, labels)
    mask_labels = labels != padding_idx
    # ≥1 unmasked: if every non-pad position is a label, unmask one random label
    all_masked = (mask_labels.sum(dim=1) == non_pad.sum(dim=1))[:, None]
    candidates = mask_labels | ~mask_labels.any(dim=1, keepdim=True)
    unmask = pos == _sample_index_from_mask(candidates, generator)[:, None]
    labels = torch.where(all_masked & unmask, torch.full_like(labels, padding_idx), labels)
    return labels, labels != padding_idx


class MaskSequence(nn.Module):
    """Base: holds the trainable [MASK] embedding; subclasses implement
    ``compute_masked_targets`` and ``apply_mask_to_inputs``."""

    def __init__(self, hidden_size: int = 0, padding_idx: int = 0,
                 eval_on_last_item_seq_only: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.padding_idx = padding_idx
        self.eval_on_last_item_seq_only = eval_on_last_item_seq_only
        self.masked_item_embedding = nn.Parameter(torch.empty(hidden_size))

    def _init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.masked_item_embedding, 0.0, 0.001, generator=generator)

    def compute_masked_targets(self, item_ids, training=False, testing=False,
                               generator=None) -> MaskingInfo:
        raise NotImplementedError

    def apply_mask_to_inputs(self, inputs, info: MaskingInfo, training=False, testing=False):
        """Default: replace masked positions with the trainable embedding."""
        if not training and not testing:
            return inputs
        mask_emb = self.masked_item_embedding.to(inputs.dtype)
        return torch.where(info.input_schema[..., None], mask_emb, inputs)

    def forward(self, inputs, item_ids, training: bool = False, testing: bool = False,
                segment_ids=None, generator: Optional[torch.Generator] = None,
                masking_info: Optional[MaskingInfo] = None):
        """``generator`` feeds the training draw; a ready ``masking_info``
        (targets, mask, input_schema, pad_mask) replaces it."""
        if item_ids.dim() != 2:
            raise ValueError("`item_ids` must have 2 dimensions (batch, seq)")
        if segment_ids is not None:
            raise NotImplementedError("session packing (segment_ids) is not ported yet")
        if masking_info is not None:
            info = masking_info
        else:
            info = self.compute_masked_targets(item_ids, training=training, testing=testing,
                                               generator=generator)
        masked = self.apply_mask_to_inputs(inputs, info, training=training, testing=testing)
        return masked, info


@masking_registry.register("clm", "causal")
class CausalLanguageModeling(MaskSequence):
    """Next-item (causal) labels."""

    def __init__(self, hidden_size: int = 0, padding_idx: int = 0,
                 eval_on_last_item_seq_only: bool = True,
                 train_on_last_item_seq_only: bool = False):
        super().__init__(hidden_size, padding_idx, eval_on_last_item_seq_only)
        self.train_on_last_item_seq_only = train_on_last_item_seq_only

    def compute_masked_targets(self, item_ids, training=False, testing=False,
                               generator=None) -> MaskingInfo:
        non_pad = item_ids != self.padding_idx
        if not training and not testing:
            # inference: identity targets, mask = non-pad
            return MaskingInfo(targets=item_ids, mask=non_pad, input_schema=non_pad,
                               pad_mask=non_pad)
        labels, mask = _predict_all(item_ids, self.padding_idx)
        if (self.eval_on_last_item_seq_only and not training) or (
            self.train_on_last_item_seq_only and training
        ):
            # keep only the label at the last target position; the input
            # schema reverts to the full non-pad mask
            last = (mask.sum(dim=1) - 1).clamp_min(0)
            keep = torch.arange(labels.shape[1], device=labels.device)[None, :] == last[:, None]
            labels = torch.where(keep, labels, torch.full_like(labels, self.padding_idx))
            return MaskingInfo(targets=labels, mask=labels != self.padding_idx,
                               input_schema=non_pad, pad_mask=non_pad)
        return MaskingInfo(targets=labels, mask=mask, input_schema=mask, pad_mask=non_pad)

    def apply_mask_to_inputs(self, inputs, info: MaskingInfo, training=False, testing=False):
        mask_emb = self.masked_item_embedding.to(inputs.dtype)
        if not training and not testing:
            # padded positions take the trainable embedding
            return torch.where(info.input_schema[..., None], inputs, mask_emb)
        # drop the last position's embedding (it has no next-item target),
        # then put the trainable embedding at the non-target positions
        trimmed = torch.cat([inputs[:, :-1], torch.zeros_like(inputs[:, -1:])], dim=1)
        return torch.where(info.input_schema[..., None], trimmed, mask_emb)


@masking_registry.register("mlm", "masked")
class MaskedLanguageModeling(MaskSequence):
    """BERT-style random masking."""

    def __init__(self, hidden_size: int = 0, padding_idx: int = 0,
                 eval_on_last_item_seq_only: bool = True, mlm_probability: float = 0.15):
        super().__init__(hidden_size, padding_idx, eval_on_last_item_seq_only)
        self.mlm_probability = mlm_probability

    def compute_masked_targets(self, item_ids, training=False, testing=False,
                               generator=None) -> MaskingInfo:
        non_pad = item_ids != self.padding_idx
        B, S = item_ids.shape
        if training:
            bern = torch.rand(item_ids.shape, generator=generator,
                              device=item_ids.device) < self.mlm_probability
            mask_labels = bern & non_pad
            labels = torch.where(mask_labels, item_ids,
                                 torch.full_like(item_ids, self.padding_idx))
            labels, mask_labels = _ensure_min_masking(
                labels, mask_labels, item_ids, non_pad, self.padding_idx, generator
            )
            return MaskingInfo(targets=labels, mask=mask_labels, input_schema=mask_labels,
                               pad_mask=non_pad)
        if not testing:
            # inference: extend by one [MASK] position at index len
            last_len = non_pad.sum(dim=1)  # first padded position
            rows = torch.arange(B, device=item_ids.device)
            labels = torch.full((B, S + 1), self.padding_idx, dtype=item_ids.dtype,
                                device=item_ids.device)
            last_items = item_ids[rows, (last_len - 1).clamp_min(0)]
            labels[rows, last_len] = last_items
            mask = labels != self.padding_idx
            ext_pad = torch.arange(S + 1, device=item_ids.device)[None, :] < (last_len + 1)[:, None]
            return MaskingInfo(targets=labels, mask=mask, input_schema=mask, pad_mask=ext_pad)
        if self.eval_on_last_item_seq_only:
            labels, mask = _label_at_last(item_ids, non_pad, self.padding_idx)
        else:
            labels, mask = _predict_all(item_ids, self.padding_idx)
        return MaskingInfo(targets=labels, mask=mask, input_schema=mask, pad_mask=non_pad)

    def apply_mask_to_inputs(self, inputs, info: MaskingInfo, training=False, testing=False):
        mask_emb = self.masked_item_embedding.to(inputs.dtype)
        if not training and not testing:
            # extend inputs by one position (a copy of the last), then put the
            # [MASK] embedding at the target position
            inputs = torch.cat([inputs, inputs[:, -1:, :]], dim=1)
        return torch.where(info.input_schema[..., None], mask_emb, inputs)


@masking_registry.register("plm", "permutation")
class PermutationLanguageModeling(MaskSequence):
    """XLNet-style permutation LM. ``perm_mask[b, i, j] = 1``: position i
    may not attend position j. The query stream predicts every position
    itself (the reference's ``target_mapping`` is the identity), so no
    gather is needed."""

    def __init__(self, hidden_size: int = 0, padding_idx: int = 0,
                 eval_on_last_item_seq_only: bool = True, plm_probability: float = 1 / 6,
                 max_span_length: int = 5, permute_all: bool = False):
        super().__init__(hidden_size, padding_idx, eval_on_last_item_seq_only)
        self.plm_probability = plm_probability
        self.max_span_length = max_span_length
        self.permute_all = permute_all

    def _sample_spans(self, non_pad: torch.Tensor, generator) -> torch.Tensor:
        """A fixed number of segments per row, each of ``context`` positions
        (a span of 1..``max_span_length`` masked items at a random offset
        inside it, ``context = span / plm_probability``), walked from the
        row's start while it lies inside the session."""
        B, S = non_pad.shape
        dev = non_pad.device
        max_len = non_pad.sum(dim=1)
        min_context = max(int(1 / self.plm_probability), 1)
        segments = -(-S // min_context) + 1  # an upper bound on the segments a row needs
        span = torch.randint(1, self.max_span_length + 1, (segments, B), generator=generator,
                             device=dev)
        context = (span / self.plm_probability).to(torch.int32).long()
        offsets = torch.rand((segments, B), generator=generator, device=dev)
        cur = context.cumsum(0) - context  # where each segment starts
        width = (context - span + 1).clamp_min(1)
        start = cur + (offsets * width).long().clamp_max(width - 1)
        pos = torch.arange(S, device=dev)
        in_span = (pos >= start[..., None]) & (pos < (start + span)[..., None])
        valid = (start < max_len) & (cur < max_len)
        mask = (in_span & valid[..., None]).any(dim=0)
        return mask & non_pad

    def compute_masked_targets(self, item_ids, training=False, testing=False,
                               generator=None) -> MaskingInfo:
        non_pad = item_ids != self.padding_idx
        B, S = item_ids.shape
        dev = item_ids.device
        if training:
            # the draws in one order: spans, the ≥1 guarantee, the permutation
            mask_labels = non_pad if self.permute_all else self._sample_spans(non_pad, generator)
            labels = torch.where(mask_labels, item_ids,
                                 torch.full_like(item_ids, self.padding_idx))
            labels, mask_labels = _ensure_min_masking(
                labels, mask_labels, item_ids, non_pad, self.padding_idx, generator
            )
            # a random factorisation order; positions not masked get -1: every
            # query sees them, and they see no masked position
            order = torch.argsort(torch.rand((B, S), generator=generator, device=dev), dim=-1)
            order = torch.where(mask_labels, order, -1)
            # i may not attend j iff j is masked and not before i in the order
            perm_mask = ((order[:, :, None] <= order[:, None, :])
                         & mask_labels[:, None, :]).float()
            return MaskingInfo(targets=labels, mask=mask_labels, input_schema=mask_labels,
                               perm_mask=perm_mask, pad_mask=non_pad)
        # evaluation and inference: the causal order
        causal = torch.ones((S, S), device=dev).triu(1)[None]
        if self.eval_on_last_item_seq_only:
            labels, mask = _label_at_last(item_ids, non_pad, self.padding_idx)
            # no query sees the last item
            perm_mask = (causal + mask[:, None, :].float()).clamp(0, 1)
        else:
            labels, mask = _predict_all(item_ids, self.padding_idx)
            perm_mask = causal.expand(B, S, S)
        return MaskingInfo(targets=labels, mask=mask, input_schema=mask, perm_mask=perm_mask,
                           pad_mask=non_pad)


@masking_registry.register("rtd", "replacement")
class ReplacementLanguageModeling(MaskedLanguageModeling):
    """ELECTRA's replacement-token detection: MLM's masking for the
    generator, and helpers that build the discriminator's corrupted inputs
    and labels. Each helper draws from ``generator`` (on the ids' device) or
    takes its draw handed in, so that two devices, or two packages, can be
    given the same noise."""

    def __init__(self, hidden_size: int = 0, padding_idx: int = 0,
                 eval_on_last_item_seq_only: bool = True, mlm_probability: float = 0.15,
                 sample_from_batch: bool = False):
        super().__init__(hidden_size, padding_idx, eval_on_last_item_seq_only, mlm_probability)
        self.sample_from_batch = sample_from_batch

    @staticmethod
    def sample_from_softmax(logits: torch.Tensor, generator=None,
                            uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One id per row of ``logits`` (..., V) by the Gumbel-max trick;
        ``uniform`` (the shape of ``logits``, in [0, 1)) replaces the draw."""
        if uniform is None:
            uniform = torch.rand(logits.shape, generator=generator, device=logits.device,
                                 dtype=logits.dtype)
        gumbel = -torch.log(-torch.log(uniform + 1e-9) + 1e-9)
        return torch.argmax(logits + gumbel, dim=-1)

    def get_fake_tokens(self, item_ids: torch.Tensor, targets: torch.Tensor,
                        logits: Optional[torch.Tensor] = None, generator=None,
                        draw: Optional[torch.Tensor] = None):
        """``(corrupted (B, S), discriminator labels (B, S) bool, samples)``.
        Every position is sampled, only the masked ones (targets not padding)
        are replaced: from the generator's ``logits`` (B, S, V), or, with
        ``sample_from_batch`` or no logits, from the batch's own non-pad ids.
        A label is True where the id changed. ``draw`` is the helper's draw:
        the uniforms of ``sample_from_softmax`` or the ranks of
        ``sample_from_batch_ids``."""
        mask = targets != self.padding_idx
        if self.sample_from_batch or logits is None:
            samples = self.sample_from_batch_ids(item_ids, generator, draw)
        else:
            samples = self.sample_from_softmax(logits, generator, draw)
        corrupted = torch.where(mask, samples.to(item_ids.dtype), item_ids)
        # a sample equal to the true id stays "real"
        return corrupted, (corrupted != item_ids) & mask, samples

    def sample_from_batch_ids(self, item_ids: torch.Tensor, generator=None,
                              draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) ids drawn uniformly from the batch's non-pad ids: a draw k
        in 1..n (n the non-pad count) picks the k-th non-pad id, found by
        ``searchsorted`` over the running count. ``draws`` (B·S,) replaces
        the draw."""
        B, S = item_ids.shape
        flat = item_ids.reshape(-1)
        cum = torch.cumsum((flat != self.padding_idx).to(torch.int64), 0)
        total = cum[-1].clamp_min(1)
        if draws is None:
            u = torch.rand(B * S, generator=generator, device=item_ids.device,
                           dtype=torch.float64)
            draws = torch.minimum((u * total).long() + 1, total)
        idx = torch.searchsorted(cum, draws.to(cum.dtype), side="left").clamp(0, B * S - 1)
        return flat[idx].reshape(B, S)
