"""Masking / label generation: masked language modeling (MLM).

Counterpart of ``transformers4rec_tpu/masking.py``. Masking is pure label
generation: ``(embeds, item_ids, flags) → (masked_embeds, MaskingInfo)``;
nothing is stored on the module but the trainable [MASK] embedding.

Ported: ``MaskingInfo``, ``MaskSequence`` and ``MaskedLanguageModeling`` in
its inference branch (one [MASK] position appended at index ``len``), its
testing branch (the label at the last item) and its training branch
(Bernoulli masking with the ≥1-masked / ≥1-unmasked guarantee). Random draws
come from an explicit ``torch.Generator`` on the tensors' device; a caller
may instead hand ``MaskSequence.forward`` a ready ``MaskingInfo``
(``masking_info=``), which skips the draw: that is how two devices, or two
packages, are given the same mask. Not ported yet (raise
``NotImplementedError``): session packing (``segment_ids``) and the CLM, PLM
and RTD schemes.
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
    pad_mask: (B, S') bool — True at real (non-pad) positions of the
        post-masking sequence; S' = S+1 under the MLM inference extension.
    item_ids / item_table: the raw item-id sequence and the tied item table,
        filled by TabularSequenceFeatures for the prediction head.
    """

    targets: torch.Tensor
    mask: torch.Tensor
    input_schema: torch.Tensor
    perm_mask: Optional[torch.Tensor] = None
    pad_mask: Optional[torch.Tensor] = None
    item_ids: Optional[torch.Tensor] = None
    item_table: Optional[torch.Tensor] = None
    segment_ids: Optional[torch.Tensor] = None

    def replace(self, **kwargs) -> "MaskingInfo":
        return dataclasses.replace(self, **kwargs)


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
        if not self.eval_on_last_item_seq_only:
            raise NotImplementedError(
                "MLM testing on every position (eval_on_last_item_seq_only=False) "
                "is not ported yet"
            )
        labels, mask = _label_at_last(item_ids, non_pad, self.padding_idx)
        return MaskingInfo(targets=labels, mask=mask, input_schema=mask, pad_mask=non_pad)

    def apply_mask_to_inputs(self, inputs, info: MaskingInfo, training=False, testing=False):
        mask_emb = self.masked_item_embedding.to(inputs.dtype)
        if not training and not testing:
            # extend inputs by one position (a copy of the last), then put the
            # [MASK] embedding at the target position
            inputs = torch.cat([inputs, inputs[:, -1:, :]], dim=1)
        return torch.where(info.input_schema[..., None], mask_emb, inputs)
