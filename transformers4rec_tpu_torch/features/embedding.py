"""Embedding feature input blocks: table configs and lookups.

Counterpart of ``transformers4rec_tpu/features/embedding.py``
(``TableConfig``/``FeatureConfig``, ``EmbeddingFeatures``,
``SequenceEmbeddingFeatures``). Padding id 0 is masked explicitly (the
looked-up row is multiplied by ``ids != padding_idx``), and table rows are
rounded up to ``vocab_padding_multiple`` with the true vocab kept by the
prediction head, exactly as in the JAX package.

A table may be held as a shard: after ``shard_table(name, group)`` the
module keeps rows ``[rank·V_l, (rank+1)·V_l)`` of that table and looks ids up
through ``parallel.sharded_embedding_lookup`` (a masked local gather and one
sum over the process group). The JAX package leaves that to its compiler's
partitioner; here it is explicit.

Not ported yet: soft and pretrained embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.sharded_embedding import shard_table, sharded_embedding_lookup
from ..schema import Schema, Tags, get_embedding_size_from_cardinality
from ..tabular.base import TabularBlock, TabularData


@dataclasses.dataclass(frozen=True)
class TableConfig:
    vocabulary_size: int
    dim: int
    # ``initializer(tensor, generator)`` fills the table in place; None →
    # normal(0, 0.05), the JAX package's default
    initializer: Optional[Callable] = None
    combiner: str = "mean"
    name: str = ""


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    table: TableConfig
    max_sequence_length: int = 0
    name: str = ""


def _default_initializer(std: float = 0.05) -> Callable:
    def init(t: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.normal_(t, 0.0, std, generator=generator)

    return init


def _infer_dims(
    schema: Schema,
    embedding_dims: Optional[Dict[str, int]],
    embedding_dim_default: int,
    infer_embedding_sizes: bool,
    infer_embedding_sizes_multiplier: float,
) -> Dict[str, int]:
    """Per-feature dims: explicit dict > cardinality heuristic > default."""
    cardinalities = schema.categorical_cardinalities()
    dims: Dict[str, int] = {}
    for name, card in cardinalities.items():
        if embedding_dims and name in embedding_dims:
            dims[name] = embedding_dims[name]
        elif infer_embedding_sizes:
            dims[name] = get_embedding_size_from_cardinality(
                card, infer_embedding_sizes_multiplier
            )
        else:
            dims[name] = embedding_dim_default
    return dims


def build_feature_configs(
    schema: Schema,
    embedding_dims: Optional[Dict[str, int]] = None,
    embedding_dim_default: int = 64,
    infer_embedding_sizes: bool = False,
    infer_embedding_sizes_multiplier: float = 2.0,
    embeddings_initializers: Optional[Dict[str, Callable]] = None,
    combiner: str = "mean",
    max_sequence_length: int = 0,
) -> Dict[str, FeatureConfig]:
    dims = _infer_dims(
        schema,
        embedding_dims,
        embedding_dim_default,
        infer_embedding_sizes,
        infer_embedding_sizes_multiplier,
    )
    configs: Dict[str, FeatureConfig] = {}
    for name, card in schema.categorical_cardinalities().items():
        init = (embeddings_initializers or {}).get(name) or _default_initializer()
        configs[name] = FeatureConfig(
            table=TableConfig(
                vocabulary_size=card, dim=dims[name], initializer=init,
                combiner=combiner, name=name,
            ),
            max_sequence_length=max_sequence_length,
            name=name,
        )
    return configs


class EmbeddingFeatures(TabularBlock):
    """Categorical lookups producing one (B, dim) tensor per feature.

    2-D (B, S) inputs are combined over the sequence (mean over non-pad
    positions, or sum). For 3-D sequence outputs use
    ``SequenceEmbeddingFeatures``.
    """

    def __init__(
        self,
        feature_configs: Dict[str, FeatureConfig],
        item_id: Optional[str] = None,
        mask_padding: bool = True,
        padding_idx: int = 0,
        table_dtype: torch.dtype = torch.float32,
        vocab_padding_multiple: int = 8,
        schema: Optional[Schema] = None,
        aggregation=None,
    ):
        super().__init__(aggregation=aggregation, schema=schema)
        self.feature_configs = dict(feature_configs)
        self.item_id = item_id
        self.mask_padding = mask_padding
        self.padding_idx = padding_idx
        # rows rounded up to ``vocab_padding_multiple``: padded rows are never
        # looked up (ids < true vocab) and the prediction head bounds softmax
        # and top-k by the true vocab (NextItemPredictionTask.target_dim)
        m = max(int(vocab_padding_multiple), 1)
        self.tables = nn.ParameterDict()
        for name, fc in self.feature_configs.items():
            rows = ((fc.table.vocabulary_size + m - 1) // m) * m
            self.tables[name] = nn.Parameter(
                torch.empty(rows, fc.table.dim, dtype=table_dtype)
            )
        # name -> process group, for the tables of which this module holds a shard
        self.table_groups: Dict[str, object] = {}

    @classmethod
    def from_schema(
        cls,
        schema: Schema,
        embedding_dims: Optional[Dict[str, int]] = None,
        embedding_dim_default: int = 64,
        infer_embedding_sizes: bool = False,
        infer_embedding_sizes_multiplier: float = 2.0,
        embeddings_initializers: Optional[Dict[str, Callable]] = None,
        combiner: str = "mean",
        tags=(Tags.CATEGORICAL,),
        max_sequence_length: int = 0,
        **kwargs,
    ):
        selected = schema.select_by_tag(list(tags))
        configs = build_feature_configs(
            selected,
            embedding_dims=embedding_dims,
            embedding_dim_default=embedding_dim_default,
            infer_embedding_sizes=infer_embedding_sizes,
            infer_embedding_sizes_multiplier=infer_embedding_sizes_multiplier,
            embeddings_initializers=embeddings_initializers,
            combiner=combiner,
            max_sequence_length=max_sequence_length,
        )
        try:
            item_id = selected.item_id_column_name
        except ValueError:
            item_id = None
        return cls(feature_configs=configs, item_id=item_id, schema=selected, **kwargs)

    def shard_table(self, name: str, group) -> None:
        """Keep this rank's rows of table ``name``; its lookups then go
        through the process ``group``. The rows must divide by its size."""
        if name in self.table_groups:
            raise ValueError(f"table {name!r} is sharded already")
        local = shard_table(self.tables[name].detach(), dist.get_rank(group),
                            dist.get_world_size(group))
        self.tables[name] = nn.Parameter(local.clone())
        self.table_groups[name] = group

    def _init_weights(self, generator: torch.Generator) -> None:
        for name, fc in self.feature_configs.items():
            init = fc.table.initializer or _default_initializer()
            table = self.tables[name]
            with torch.no_grad():
                if name in self.table_groups:
                    # draw the whole table, as an unsharded module would from
                    # the same generator, and keep the local rows
                    group = self.table_groups[name]
                    world = dist.get_world_size(group)
                    full = torch.empty(table.shape[0] * world, table.shape[1],
                                       dtype=table.dtype)
                    init(full, generator)
                    table.copy_(shard_table(full, dist.get_rank(group), world))
                else:
                    init(table, generator)

    def item_embedding_table(self) -> torch.Tensor:
        """The item-id table — read by NextItemPredictionTask for weight tying."""
        if self.item_id is None:
            raise ValueError("No item_id feature in this embedding module")
        return self.tables[self.item_id]

    def lookup(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        # F.embedding gathers the same rows as tables[name][ids]; its backward
        # is the embedding's own dense scatter-add, not a generic index_put
        if name in self.table_groups:
            emb = sharded_embedding_lookup(self.tables[name], ids, self.table_groups[name])
        else:
            emb = F.embedding(ids, self.tables[name])
        if self.mask_padding:
            emb = emb * (ids != self.padding_idx)[..., None].to(emb.dtype)
        return emb

    def compute_feature(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        emb = self.lookup(name, ids)
        if ids.dim() == 2:  # (B, S) → combine to (B, dim)
            if self.feature_configs[name].table.combiner == "sum":
                return emb.sum(dim=1)
            if self.mask_padding:
                valid = (ids != self.padding_idx).sum(dim=-1, keepdim=True).to(emb.dtype)
                return emb.sum(dim=1) / valid.clamp_min(1.0)
            return emb.mean(dim=1)
        return emb

    def compute(self, inputs: TabularData) -> TabularData:
        out: TabularData = {}
        for name in self.feature_configs:
            if name in inputs:
                out[name] = self.compute_feature(name, inputs[name].long())
        return out

    def feature_sizes(self) -> Dict[str, int]:
        return {name: cfg.table.dim for name, cfg in self.feature_configs.items()}


class SequenceEmbeddingFeatures(EmbeddingFeatures):
    """3-D sequence lookups: (B, S) ids → (B, S, dim); pad positions zeroed."""

    def compute_feature(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        return self.lookup(name, ids)
