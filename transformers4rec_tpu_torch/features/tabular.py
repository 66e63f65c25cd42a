"""Non-sequential tabular input module.

Counterpart of ``transformers4rec_tpu/features/tabular.py``:
``TabularFeatures`` routes continuous, categorical and pretrained columns by
tag into sub-blocks. Continuous columns are either taken as they are
(``ContinuousFeatures``, a trailing dim of 1 each) or soft-embedded
(``continuous_soft_embeddings``); ``continuous_projection`` concatenates
them and applies Dense + ReLU per layer, the last one included, under the
key ``"continuous_projection"`` (weights ``continuous_projection_{i}``).
Pretrained tables (``pretrained_embeddings``) and columns tagged
``Tags.EMBEDDING`` go to a ``PretrainedEmbeddingFeatures``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..blocks.transformer import init_dense_
from ..schema import Schema, Tags
from ..tabular.base import TabularBlock, TabularData, parse_aggregation
from .continuous import ContinuousFeatures
from .embedding import EmbeddingFeatures, PretrainedEmbeddingFeatures, SoftEmbeddingFeatures

# kwargs TabularFeatures.from_schema forwards to the embedding module
_EMBEDDING_KWARGS = (
    "embedding_dims",
    "embedding_dim_default",
    "infer_embedding_sizes",
    "infer_embedding_sizes_multiplier",
    "embeddings_initializers",
    "combiner",
    "mask_padding",
    "padding_idx",
    "table_dtype",
    "vocab_padding_multiple",
)

_PRETRAINED_KWARGS = (
    "pretrained_embeddings",
    "pretrained_output_dims",
    "pretrained_trainable",
    "pretrained_projection_dim",
    "pretrained_sequence_combiner",
)


def _check_known_kwargs(kwargs):
    """Fail fast on unknown from_schema kwargs (a silently dropped option
    would run with defaults)."""
    unknown = [k for k in kwargs
               if k not in _EMBEDDING_KWARGS and k not in _PRETRAINED_KWARGS
               and k not in ("pre", "post") and not k.startswith("soft_embedding")]
    if unknown:
        raise TypeError(
            f"from_schema got unknown keyword argument(s) {unknown}; "
            f"accepted extras: {sorted(_EMBEDDING_KWARGS + _PRETRAINED_KWARGS)}"
            " + pre/post + soft_embedding_*"
        )


class TabularFeatures(TabularBlock):
    """Tag-routed input block over continuous, categorical and pretrained
    columns."""

    EMBEDDING_MODULE_CLASS = EmbeddingFeatures
    SOFT_EMBEDDING_MODULE_CLASS = SoftEmbeddingFeatures
    CONTINUOUS_MODULE_CLASS = ContinuousFeatures
    PRETRAINED_MODULE_CLASS = PretrainedEmbeddingFeatures

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
    ):
        super().__init__(aggregation=aggregation, schema=schema)
        self.continuous_module = continuous_module
        self.categorical_module = categorical_module
        self.pretrained_module = pretrained_module
        # without continuous columns the projection has nothing to project
        # and is left out, as in the JAX package
        self.continuous_projection = (tuple(continuous_projection or ()) or None
                                      if continuous_module is not None else None)
        if self.continuous_projection:
            d_in = sum(continuous_module.feature_sizes().values())
            for i, dim in enumerate(self.continuous_projection):
                self.add_module(f"continuous_projection_{i}", nn.Linear(d_in, dim))
                d_in = dim
        self.set_transformations(pre, post)

    @classmethod
    def _build_modules(
        cls,
        schema: Schema,
        continuous_tags=(Tags.CONTINUOUS,),
        categorical_tags=(Tags.CATEGORICAL,),
        continuous_soft_embeddings: bool = False,
        **kwargs,
    ) -> Tuple[Optional[TabularBlock], Optional[TabularBlock], Optional[TabularBlock]]:
        """(continuous, categorical, pretrained) sub-blocks of ``schema``."""
        _check_known_kwargs(kwargs)
        continuous = categorical = pretrained = None
        if continuous_tags:
            cont_schema = schema.select_by_tag(list(continuous_tags))
            if len(cont_schema) > 0:
                if continuous_soft_embeddings:
                    continuous = cls.SOFT_EMBEDDING_MODULE_CLASS.from_schema(
                        cont_schema,
                        **{k: v for k, v in kwargs.items() if k.startswith("soft_embedding")},
                    )
                else:
                    continuous = cls.CONTINUOUS_MODULE_CLASS(
                        features=tuple(cont_schema.column_names), schema=cont_schema
                    )
        if categorical_tags:
            cat_schema = schema.select_by_tag(list(categorical_tags))
            if len(cat_schema) > 0:
                categorical = cls.EMBEDDING_MODULE_CLASS.from_schema(
                    cat_schema, **{k: v for k, v in kwargs.items() if k in _EMBEDDING_KWARGS})
        # pretrained: explicit {column: matrix} tables looked up in the model,
        # or columns tagged Tags.EMBEDDING whose batch values are vectors
        tables = kwargs.get("pretrained_embeddings") or {}
        precomputed = tuple(n for n in schema.select_by_tag([Tags.EMBEDDING]).column_names
                            if n not in tables)
        if tables or precomputed:
            dims = kwargs.get("pretrained_output_dims") or {}
            if isinstance(dims, int):
                dims = {n: dims for n in precomputed}
            pretrained = cls.PRETRAINED_MODULE_CLASS(
                pretrained_embeddings=dict(tables), precomputed_features=precomputed,
                precomputed_dims=dims, trainable=kwargs.get("pretrained_trainable", False),
                projection_dim=kwargs.get("pretrained_projection_dim"),
                sequence_combiner=kwargs.get("pretrained_sequence_combiner"),
            )
        return continuous, categorical, pretrained

    @staticmethod
    def _projection_dims(continuous_projection) -> Optional[Tuple[int, ...]]:
        if isinstance(continuous_projection, int):
            return (continuous_projection,)
        return tuple(continuous_projection) if continuous_projection else None

    @classmethod
    def from_schema(
        cls,
        schema: Schema,
        continuous_tags=(Tags.CONTINUOUS,),
        categorical_tags=(Tags.CATEGORICAL,),
        aggregation: Optional[str] = None,
        continuous_projection: Optional[Union[int, Sequence[int]]] = None,
        continuous_soft_embeddings: bool = False,
        **kwargs,
    ) -> "TabularFeatures":
        modules = cls._build_modules(schema, continuous_tags, categorical_tags,
                                     continuous_soft_embeddings, **kwargs)
        return cls(*modules, continuous_projection=cls._projection_dims(continuous_projection),
                   pre=kwargs.get("pre"), post=kwargs.get("post"),
                   aggregation=aggregation, schema=schema)

    @property
    def item_id(self) -> Optional[str]:
        if self.categorical_module is not None:
            return getattr(self.categorical_module, "item_id", None)
        return None

    @property
    def padding_idx(self) -> int:
        """The id marking padding (the embedding layer's convention)."""
        if self.categorical_module is not None:
            return int(getattr(self.categorical_module, "padding_idx", 0))
        return 0

    def item_embedding_table(self) -> torch.Tensor:
        if self.categorical_module is None:
            raise ValueError("No categorical module")
        return self.categorical_module.item_embedding_table()

    def _init_weights(self, generator: torch.Generator) -> None:
        for i in range(len(self.continuous_projection or ())):
            init_dense_(getattr(self, f"continuous_projection_{i}"), generator)

    def _project_continuous(self, cont: TabularData) -> TabularData:
        """Concatenate the continuous features; Dense + ReLU per layer."""
        x = parse_aggregation("concat")(cont)
        for i in range(len(self.continuous_projection)):
            x = torch.relu(getattr(self, f"continuous_projection_{i}")(x))
        return {"continuous_projection": x}

    def compute(self, inputs: TabularData, training: bool = False, pad_mask=None,
                generator=None, item_rows=None) -> TabularData:
        """``item_rows`` (``ops.sparse_update.GatheredRows``) replaces the
        item table in the item column's lookup."""
        out: TabularData = {}
        if self.continuous_module is not None:
            cont = self.continuous_module(inputs)
            if self.continuous_projection:
                cont = self._project_continuous(cont)
            out.update(cont)
        if self.categorical_module is not None:
            if item_rows is None:
                out.update(self.categorical_module(inputs))
            else:
                out.update(self.categorical_module.compute(inputs, item_rows=item_rows))
        if self.pretrained_module is not None:
            out.update(self.pretrained_module(inputs))
        return out

    def feature_sizes(self) -> Dict[str, int]:
        sizes: Dict[str, int] = {}
        if self.continuous_module is not None:
            if self.continuous_projection:
                sizes["continuous_projection"] = self.continuous_projection[-1]
            else:
                sizes.update(self.continuous_module.feature_sizes())
        if self.categorical_module is not None:
            sizes.update(self.categorical_module.feature_sizes())
        if self.pretrained_module is not None:
            sizes.update(self.pretrained_module.feature_sizes())
        return sizes
