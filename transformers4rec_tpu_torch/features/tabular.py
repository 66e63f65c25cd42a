"""Non-sequential tabular input module.

Counterpart of ``transformers4rec_tpu/features/tabular.py``:
``TabularFeatures`` routes continuous and categorical columns by tag into
sub-blocks.

Not ported yet (raise ``NotImplementedError``): the continuous projection
MLP, continuous soft embeddings and pretrained embeddings.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..schema import Schema, Tags
from ..tabular.base import TabularBlock, TabularData
from .continuous import ContinuousFeatures
from .embedding import EmbeddingFeatures

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


def _check_known_kwargs(kwargs):
    """Fail fast on unknown from_schema kwargs (a silently dropped option
    would run with defaults)."""
    unknown = [k for k in kwargs if k not in _EMBEDDING_KWARGS]
    if unknown:
        raise TypeError(
            f"from_schema got unknown keyword argument(s) {unknown}; "
            f"accepted extras: {sorted(_EMBEDDING_KWARGS)}"
        )


class TabularFeatures(TabularBlock):
    """Tag-routed input block over continuous + categorical columns."""

    EMBEDDING_MODULE_CLASS = EmbeddingFeatures
    CONTINUOUS_MODULE_CLASS = ContinuousFeatures

    def __init__(
        self,
        continuous_module: Optional[TabularBlock] = None,
        categorical_module: Optional[TabularBlock] = None,
        aggregation=None,
        schema: Optional[Schema] = None,
    ):
        super().__init__(aggregation=aggregation, schema=schema)
        self.continuous_module = continuous_module
        self.categorical_module = categorical_module

    @classmethod
    def _build_modules(
        cls,
        schema: Schema,
        continuous_tags=(Tags.CONTINUOUS,),
        categorical_tags=(Tags.CATEGORICAL,),
        continuous_projection: Optional[Union[int, Sequence[int]]] = None,
        continuous_soft_embeddings: bool = False,
        **kwargs,
    ) -> Tuple[Optional[TabularBlock], Optional[TabularBlock]]:
        _check_known_kwargs(kwargs)
        if continuous_projection is not None:
            raise NotImplementedError("continuous_projection is not ported yet")
        if continuous_soft_embeddings:
            raise NotImplementedError("continuous soft embeddings are not ported yet")
        if len(schema.select_by_tag([Tags.EMBEDDING])) > 0:
            raise NotImplementedError("pretrained embedding columns are not ported yet")
        continuous = categorical = None
        if continuous_tags:
            cont_schema = schema.select_by_tag(list(continuous_tags))
            if len(cont_schema) > 0:
                continuous = cls.CONTINUOUS_MODULE_CLASS(
                    features=tuple(cont_schema.column_names), schema=cont_schema
                )
        if categorical_tags:
            cat_schema = schema.select_by_tag(list(categorical_tags))
            if len(cat_schema) > 0:
                categorical = cls.EMBEDDING_MODULE_CLASS.from_schema(cat_schema, **kwargs)
        return continuous, categorical

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
        continuous, categorical = cls._build_modules(
            schema, continuous_tags, categorical_tags, continuous_projection,
            continuous_soft_embeddings, **kwargs,
        )
        return cls(continuous, categorical, aggregation=aggregation, schema=schema)

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

    def compute(self, inputs: TabularData) -> TabularData:
        out: TabularData = {}
        if self.continuous_module is not None:
            out.update(self.continuous_module(inputs))
        if self.categorical_module is not None:
            out.update(self.categorical_module(inputs))
        return out

    def feature_sizes(self) -> Dict[str, int]:
        sizes: Dict[str, int] = {}
        if self.continuous_module is not None:
            sizes.update(self.continuous_module.feature_sizes())
        if self.categorical_module is not None:
            sizes.update(self.categorical_module.feature_sizes())
        return sizes
