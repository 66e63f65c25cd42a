"""Sequence input module: the schema → input-block factory.

Counterpart of ``transformers4rec_tpu/features/sequence.py``:
``TabularSequenceFeatures`` routes columns by tag, aggregates them (concat is
forced when masking or a projection is set), projects to ``d_output`` and
applies the masking scheme. ``forward`` returns ``(hidden, MaskingInfo | None)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..masking import MaskingInfo, MaskSequence, masking_registry
from ..schema import Schema, Tags
from ..tabular.base import TabularBlock, TabularData, parse_aggregation
from .embedding import SequenceEmbeddingFeatures
from .tabular import TabularFeatures


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class TabularSequenceFeatures(TabularFeatures):
    """Schema-driven sequential input module: embeddings + continuous →
    aggregation → projection to ``d_output`` → masking."""

    EMBEDDING_MODULE_CLASS = SequenceEmbeddingFeatures

    def __init__(
        self,
        continuous_module: Optional[TabularBlock] = None,
        categorical_module: Optional[TabularBlock] = None,
        aggregation=None,
        schema: Optional[Schema] = None,
        projection_dims: Optional[Sequence[int]] = None,
        masking: Optional[MaskSequence] = None,
        d_output: Optional[int] = None,
    ):
        super().__init__(continuous_module, categorical_module,
                         aggregation=aggregation, schema=schema)
        self.projection_dims = tuple(projection_dims) if projection_dims else None
        self.masking = masking
        self.d_output = d_output
        self.projections = nn.ModuleList()
        if self.projection_dims:
            d_in = super().output_size()
            for dim in self.projection_dims:
                self.projections.append(nn.Linear(d_in, dim))
                d_in = dim

    @classmethod
    def from_schema(
        cls,
        schema: Schema,
        continuous_tags=(Tags.CONTINUOUS,),
        categorical_tags=(Tags.CATEGORICAL,),
        aggregation: Optional[str] = None,
        continuous_projection: Optional[Union[int, Sequence[int]]] = None,
        continuous_soft_embeddings: bool = False,
        d_output: Optional[int] = None,
        masking: Optional[Union[str, MaskSequence]] = None,
        masking_kwargs: Optional[dict] = None,
        **kwargs,
    ) -> "TabularSequenceFeatures":
        # keep the embedding layer's padding convention in sync with the
        # masking scheme's (both default 0)
        if (masking_kwargs or {}).get("padding_idx") is not None:
            kwargs.setdefault("padding_idx", masking_kwargs["padding_idx"])
        continuous, categorical = cls._build_modules(
            schema, continuous_tags, categorical_tags, continuous_projection,
            continuous_soft_embeddings, **kwargs,
        )
        agg = aggregation
        if (masking is not None or d_output is not None) and not agg:
            # masking and projection need one tensor: force concat
            agg = "concat"

        projection_dims = (d_output,) if d_output is not None else None
        hidden = d_output
        mask_module: Optional[MaskSequence] = None
        if masking is not None:
            if isinstance(masking, str):
                if hidden is None:
                    sizes = {}
                    for m in (continuous, categorical):
                        if m is not None:
                            sizes.update(m.feature_sizes())
                    hidden = parse_aggregation(agg, schema).output_size(sizes)
                mask_module = masking_registry.parse(masking)(
                    hidden_size=hidden, **(masking_kwargs or {})
                )
            else:
                mask_module = masking

        return cls(
            continuous, categorical, aggregation=agg, schema=schema,
            projection_dims=projection_dims, masking=mask_module,
            d_output=d_output or hidden,
        )

    def _init_weights(self, generator: torch.Generator) -> None:
        for lin in self.projections:
            _lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def output_size(self) -> int:
        if self.projection_dims:
            return self.projection_dims[-1]
        return super().output_size()

    @property
    def masking_enabled(self) -> bool:
        return self.masking is not None

    def forward(self, inputs: TabularData, training: bool = False, testing: bool = False,
                generator: Optional[torch.Generator] = None,
                masking_info: Optional[MaskingInfo] = None):
        if "segment_ids" in inputs:
            raise NotImplementedError("session packing (segment_ids) is not ported yet")
        item_ids = None
        if self.item_id is not None and self.item_id in inputs:
            item_ids = inputs[self.item_id].long()

        outputs = self.compute(inputs)
        agg = parse_aggregation(self.aggregation, self.schema)
        if agg is None:
            return outputs, None
        hidden = agg(outputs)

        for i, lin in enumerate(self.projections):
            hidden = lin(hidden)
            if i + 1 < len(self.projections):
                hidden = torch.relu(hidden)

        info: Optional[MaskingInfo] = None
        if self.masking is not None:
            if item_ids is None:
                raise ValueError("Masking requires an item_id column in the schema/inputs")
            hidden, info = self.masking(hidden, item_ids, training=training, testing=testing,
                                        generator=generator, masking_info=masking_info)
            # thread item ids + the (tied) item table to the prediction head
            table = self.item_embedding_table() if self.item_id is not None else None
            info = info.replace(item_ids=item_ids, item_table=table)
        return hidden, info
