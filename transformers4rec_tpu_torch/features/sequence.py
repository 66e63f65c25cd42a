"""Sequence input module: the schema → input-block factory.

Counterpart of ``transformers4rec_tpu/features/sequence.py``:
``TabularSequenceFeatures`` routes columns by tag, aggregates them (concat is
forced when masking or a projection is set), projects to ``d_output`` and
applies the masking scheme. ``forward`` returns ``(hidden, MaskingInfo | None)``.

The item ids (the masking's labels and the pad mask) are read before
``pre`` runs: swap noise changes what the embeddings see, never the
labels. ``pre`` and ``post`` get the pad mask of those ids. The batch key
``__neg_ids__`` (sampled-softmax negatives drawn by the trainer) goes to
``MaskingInfo.neg_ids``. The ``projection`` MLP (``projection_{i}``) has a
ReLU between its layers and none after the last.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..masking import MaskingInfo, MaskSequence, masking_registry
from ..ops.sparse_update import GatheredRows
from ..schema import Schema, Tags
from ..blocks.transformer import Linear, init_dense_
from ..tabular.base import TabularBlock, TabularData, parse_aggregation
from .embedding import SequenceEmbeddingFeatures
from .tabular import TabularFeatures


class TabularSequenceFeatures(TabularFeatures):
    """Schema-driven sequential input module: embeddings + continuous →
    aggregation → projection to ``d_output`` → masking."""

    EMBEDDING_MODULE_CLASS = SequenceEmbeddingFeatures

    def __init__(
        self,
        continuous_module: Optional[TabularBlock] = None,
        categorical_module: Optional[TabularBlock] = None,
        pretrained_module: Optional[TabularBlock] = None,
        continuous_projection: Optional[Sequence[int]] = None,
        pre=None,
        post=None,
        aggregation=None,
        schema: Optional[Schema] = None,
        projection_dims: Optional[Sequence[int]] = None,
        masking: Optional[MaskSequence] = None,
        d_output: Optional[int] = None,
    ):
        super().__init__(continuous_module, categorical_module, pretrained_module,
                         continuous_projection, pre=pre, post=post,
                         aggregation=aggregation, schema=schema)
        self.projection_dims = tuple(projection_dims) if projection_dims else None
        self.masking = masking
        self.d_output = d_output
        self.projections = nn.ModuleList()
        if self.projection_dims:
            d_in = super().output_size()
            for dim in self.projection_dims:
                self.projections.append(Linear(d_in, dim))
                d_in = dim

    @classmethod
    def from_schema(
        cls,
        schema: Schema,
        continuous_tags=(Tags.CONTINUOUS,),
        categorical_tags=(Tags.CATEGORICAL,),
        aggregation: Optional[str] = None,
        # accepted as the JAX package does, and inert there too: shapes come
        # from the loader's max_sequence_length
        max_sequence_length: Optional[int] = None,
        continuous_projection: Optional[Union[int, Sequence[int]]] = None,
        continuous_soft_embeddings: bool = False,
        projection: Optional[Union[int, Sequence[int]]] = None,
        d_output: Optional[int] = None,
        masking: Optional[Union[str, MaskSequence]] = None,
        masking_kwargs: Optional[dict] = None,
        **kwargs,
    ) -> "TabularSequenceFeatures":
        # keep the embedding layer's padding convention in sync with the
        # masking scheme's (both default 0)
        if (masking_kwargs or {}).get("padding_idx") is not None:
            kwargs.setdefault("padding_idx", masking_kwargs["padding_idx"])
        modules = cls._build_modules(schema, continuous_tags, categorical_tags,
                                     continuous_soft_embeddings, **kwargs)
        cont_projection = cls._projection_dims(continuous_projection)
        agg = aggregation
        if (masking is not None or d_output is not None or projection is not None) and not agg:
            # masking and projection need one tensor: force concat
            agg = "concat"

        projection_dims: Optional[Tuple[int, ...]] = None
        if projection is not None:
            projection_dims = (projection,) if isinstance(projection, int) else tuple(projection)
            if d_output is not None and (not projection_dims or projection_dims[-1] != d_output):
                projection_dims += (d_output,)
        elif d_output is not None:
            projection_dims = (d_output,)

        hidden = (projection_dims[-1] if projection_dims else None) or d_output
        mask_module: Optional[MaskSequence] = None
        if masking is not None:
            if isinstance(masking, str):
                if hidden is None:
                    hidden = TabularFeatures(*modules, continuous_projection=cont_projection,
                                             aggregation=agg, schema=schema).output_size()
                mask_module = masking_registry.parse(masking)(
                    hidden_size=hidden, **(masking_kwargs or {})
                )
            else:
                mask_module = masking

        return cls(
            *modules, continuous_projection=cont_projection, pre=kwargs.get("pre"),
            post=kwargs.get("post"), aggregation=agg, schema=schema,
            projection_dims=projection_dims, masking=mask_module,
            d_output=d_output or hidden,
        )

    def _init_weights(self, generator: torch.Generator) -> None:
        super()._init_weights(generator)
        for lin in self.projections:
            init_dense_(lin, generator)

    def output_size(self) -> int:
        if self.projection_dims:
            return self.projection_dims[-1]
        return super().output_size()

    @property
    def masking_enabled(self) -> bool:
        return self.masking is not None

    def forward(self, inputs: TabularData, training: bool = False, testing: bool = False,
                generator: Optional[torch.Generator] = None,
                masking_info: Optional[MaskingInfo] = None,
                sparse_rows: Optional[GatheredRows] = None):
        """``sparse_rows`` (the sparse step's pre-gathered table rows): the
        item column's lookup reads them instead of the table, and the swap
        noise they carry (``aug_inputs``) replaces the ``pre`` draw."""
        item_ids = None
        if self.item_id is not None and self.item_id in inputs:
            item_ids = inputs[self.item_id].long()
        pad_mask = item_ids != self.padding_idx if item_ids is not None else None

        if sparse_rows is not None and sparse_rows.aug_inputs is not None:
            inputs = {k: sparse_rows.aug_inputs.get(k, v) for k, v in inputs.items()}
        else:
            inputs = self._transform(self._pre_names, inputs, training, pad_mask, generator)
        outputs = self.compute(inputs, item_rows=sparse_rows)
        outputs = self._transform(self._post_names, outputs, training, pad_mask, generator)
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
            # session packing: the batch's (B, S) ``segment_ids`` (not a schema
            # feature) rides through the masking's info to the encoder
            hidden, info = self.masking(hidden, item_ids, training=training, testing=testing,
                                        segment_ids=inputs.get("segment_ids"),
                                        generator=generator, masking_info=masking_info)
            # thread item ids + the (tied) item table to the prediction head
            table = self.item_embedding_table() if self.item_id is not None else None
            info = info.replace(item_ids=item_ids, item_table=table)
            if "__neg_ids__" in inputs:
                # the reserved batch key (never a schema feature): negatives
                # the trainer drew for the sampled softmax
                info = info.replace(neg_ids=inputs["__neg_ids__"].long())
        return hidden, info
