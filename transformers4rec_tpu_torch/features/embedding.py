"""Embedding feature input blocks: table configs, lookups, soft and
pretrained embeddings.

Counterpart of ``transformers4rec_tpu/features/embedding.py``
(``TableConfig``/``FeatureConfig``, ``EmbeddingFeatures``,
``SequenceEmbeddingFeatures``, ``SoftEmbedding``/``SoftEmbeddingFeatures``,
``PretrainedEmbeddingFeatures``, ``PretrainedEmbeddingsInitializer``). A
table initialised by a ``PretrainedEmbeddingsInitializer(...,
trainable=False)``, and the matrices of a ``PretrainedEmbeddingFeatures``
that is not trainable, are parameters without ``requires_grad``: they take
no gradient and no optimizer step, as the JAX package's ``stop_gradient``
gives. Padding id 0 is masked explicitly (the
looked-up row is multiplied by ``ids != padding_idx``), and table rows are
rounded up to ``vocab_padding_multiple`` with the true vocab kept by the
prediction head, exactly as in the JAX package.

The sparse embedding step hands the item column's lookup rows it gathered
itself (``item_rows``, an ``ops.sparse_update.GatheredRows``): the table is
then not read, and takes no gradient.

A table may be held as a shard: after ``shard_table(name, group)`` the
module keeps rows ``[rank·V_l, (rank+1)·V_l)`` of that table and looks ids up
through ``parallel.sharded_embedding_lookup`` (a masked local gather and one
sum over the process group). The JAX package leaves that to its compiler's
partitioner; here it is explicit. After ``split_table(name, devices)`` a
process holds all the shards of a table itself, one a device, for serving:
the table leaves the parameters, ``item_embedding_table()`` returns the
list of shards and lookups sum their masked gathers without a group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.sharded_embedding import shard_table, sharded_embedding_lookup
from ..schema import Schema, Tags, get_embedding_size_from_cardinality
from ..blocks.transformer import Linear, init_dense_, promote
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
                torch.empty(rows, fc.table.dim, dtype=table_dtype),
                requires_grad=getattr(fc.table.initializer, "trainable", True) is not False,
            )
        # name -> process group, for the tables of which this module holds a shard
        self.table_groups: Dict[str, object] = {}
        # name -> every shard of a table split inside this process (serving)
        self.table_shards: Dict[str, List[torch.Tensor]] = {}

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

    def split_table(self, name: str, devices: Sequence) -> None:
        """Hold table ``name`` as ``len(devices)`` row shards in this
        process, shard i on ``devices[i]``; the table leaves the module's
        parameters. The rows must divide by the number of shards."""
        if name in self.table_groups or name in self.table_shards:
            raise ValueError(f"table {name!r} is sharded already")
        table = self.tables[name].detach()
        n = len(devices)
        self.table_shards[name] = [shard_table(table, i, n).to(dev, copy=True)
                                   for i, dev in enumerate(devices)]
        del self.tables[name]

    def _init_weights(self, generator: torch.Generator) -> None:
        for name, fc in self.feature_configs.items():
            if name in self.table_shards:
                continue
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

    def item_embedding_table(self):
        """The item-id table — read by NextItemPredictionTask for weight
        tying: this rank's shard of a table sharded over a group, the list
        of shards of one split inside this process."""
        if self.item_id is None:
            raise ValueError("No item_id feature in this embedding module")
        if self.item_id in self.table_shards:
            return self.table_shards[self.item_id]
        return self.tables[self.item_id]

    def lookup(self, name: str, ids: torch.Tensor, item_rows=None) -> torch.Tensor:
        """``item_rows`` (``ops.sparse_update.GatheredRows``, item column
        only): the rows were gathered already, the table is not read."""
        # F.embedding gathers the same rows as tables[name][ids]; its backward
        # is the embedding's own dense scatter-add, not a generic index_put
        if item_rows is not None and name == self.item_id:
            emb = item_rows.lookup(ids)
        elif name in self.table_groups:
            emb = sharded_embedding_lookup(self.tables[name], ids, self.table_groups[name])
        elif name in self.table_shards:
            emb = sharded_embedding_lookup(self.table_shards[name], ids, None)
        else:
            emb = F.embedding(ids, self.tables[name])
        if self.mask_padding:
            emb = emb * (ids != self.padding_idx)[..., None].to(emb.dtype)
        return emb

    def compute_feature(self, name: str, ids: torch.Tensor, item_rows=None) -> torch.Tensor:
        emb = self.lookup(name, ids, item_rows)
        if ids.dim() == 2:  # (B, S) → combine to (B, dim)
            if self.feature_configs[name].table.combiner == "sum":
                return emb.sum(dim=1)
            if self.mask_padding:
                valid = (ids != self.padding_idx).sum(dim=-1, keepdim=True).to(emb.dtype)
                return emb.sum(dim=1) / valid.clamp_min(1.0)
            return emb.mean(dim=1)
        return emb

    def compute(self, inputs: TabularData, training: bool = False, pad_mask=None,
                generator=None, item_rows=None) -> TabularData:
        out: TabularData = {}
        for name in self.feature_configs:
            if name in inputs:
                out[name] = self.compute_feature(name, inputs[name].long(), item_rows)
        return out

    def feature_sizes(self) -> Dict[str, int]:
        return {name: cfg.table.dim for name, cfg in self.feature_configs.items()}


class SequenceEmbeddingFeatures(EmbeddingFeatures):
    """3-D sequence lookups: (B, S) ids → (B, S, dim); pad positions zeroed."""

    def compute_feature(self, name: str, ids: torch.Tensor, item_rows=None) -> torch.Tensor:
        return self.lookup(name, ids, item_rows)


class SoftEmbedding(nn.Module):
    """Soft one-hot encoding of a continuous scalar: ``num_embeddings``
    logits from a Dense(1 → K) with bias, a softmax, and the weighted
    average of the table's rows. The raw column ((B,) or (B, S)) always
    gains a trailing dim of 1."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.embedding_table = nn.Parameter(torch.empty(num_embeddings, embedding_dim))
        self.projection = Linear(1, num_embeddings)

    def _init_weights(self, generator: torch.Generator) -> None:
        _default_initializer()(self.embedding_table, generator)
        init_dense_(self.projection, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = torch.softmax(self.projection(x.float()[..., None]), dim=-1)
        # a bf16-stored table meets the f32 weights in f32, as flax promotes
        return weights @ promote(self.embedding_table, weights)


class SoftEmbeddingFeatures(TabularBlock):
    """A ``SoftEmbedding`` per continuous column, named ``soft_{column}``."""

    def __init__(self, soft_embedding_cardinalities: Mapping[str, int],
                 soft_embedding_dims: Mapping[str, int], schema: Optional[Schema] = None,
                 aggregation=None):
        super().__init__(aggregation=aggregation, schema=schema)
        self.soft_embedding_cardinalities = dict(soft_embedding_cardinalities)
        self.soft_embedding_dims = dict(soft_embedding_dims)
        for name, card in self.soft_embedding_cardinalities.items():
            self.add_module(f"soft_{name}",
                            SoftEmbedding(card, self.soft_embedding_dims[name]))

    @classmethod
    def from_schema(cls, schema: Schema, soft_embedding_cardinality_default: int = 10,
                    soft_embedding_cardinalities: Optional[Dict[str, int]] = None,
                    soft_embedding_dim_default: int = 8,
                    soft_embedding_dims: Optional[Dict[str, int]] = None,
                    tags=(Tags.CONTINUOUS,), **kwargs) -> "SoftEmbeddingFeatures":
        selected = schema.select_by_tag(list(tags))
        names = selected.column_names
        cards = {n: (soft_embedding_cardinalities or {}).get(n, soft_embedding_cardinality_default)
                 for n in names}
        dims = {n: (soft_embedding_dims or {}).get(n, soft_embedding_dim_default) for n in names}
        return cls(cards, dims, schema=selected, **kwargs)

    def compute(self, inputs, training=False, pad_mask=None, generator=None):
        return {name: getattr(self, f"soft_{name}")(inputs[name])
                for name in self.soft_embedding_cardinalities if name in inputs}

    def feature_sizes(self) -> Dict[str, int]:
        return dict(self.soft_embedding_dims)


class PretrainedEmbeddingFeatures(TabularBlock):
    """Pretrained embeddings, in two modes:

    - ``pretrained_embeddings``: ``{column: matrix}`` tables looked up in the
      model by the column's integer ids (id 0 gives zeros); a parameter
      ``{column}_pretrained`` each, frozen unless ``trainable``;
    - ``precomputed_features``: columns whose batch values are already
      vectors (``Tags.EMBEDDING``), used as they come; ``precomputed_dims``
      gives each one's width for the analytic output size.

    Then an optional ``Linear`` to ``projection_dim`` (``{column}_proj``)
    and an optional ``sequence_combiner`` (``"mean"``, over the valid
    positions, or ``"sum"``). Padded positions (id 0, or an all-zero
    vector) are zeroed before the projection and again after its bias."""

    def __init__(self, pretrained_embeddings: Optional[Mapping[str, np.ndarray]] = None,
                 precomputed_features: Sequence[str] = (),
                 precomputed_dims: Optional[Mapping[str, int]] = None,
                 trainable: bool = False, projection_dim: Optional[int] = None,
                 sequence_combiner: Optional[str] = None, schema: Optional[Schema] = None,
                 aggregation=None):
        super().__init__(aggregation=aggregation, schema=schema)
        self.precomputed_features = tuple(precomputed_features)
        self.precomputed_dims = dict(precomputed_dims or {})
        self.trainable = trainable
        self.projection_dim = projection_dim
        self.sequence_combiner = sequence_combiner
        # column -> the width of what it gives before the projection
        self.input_dims: Dict[str, int] = {}
        for name, m in (pretrained_embeddings or {}).items():
            self.register_parameter(f"{name}_pretrained", nn.Parameter(
                torch.tensor(np.asarray(m), dtype=torch.float32), requires_grad=trainable))
            self.input_dims[name] = int(np.shape(m)[-1])
        self.tables = tuple(self.input_dims)
        for name in self.precomputed_features:
            self.input_dims[name] = self.precomputed_dims.get(name, 0)
        if projection_dim:
            for name, dim in self.input_dims.items():
                self.add_module(f"{name}_proj", Linear(dim, projection_dim))

    def _init_weights(self, generator: torch.Generator) -> None:
        if self.projection_dim:
            for name in self.input_dims:
                init_dense_(getattr(self, f"{name}_proj"), generator)

    def _finish(self, name: str, emb: torch.Tensor,
                pos_valid: Optional[torch.Tensor]) -> torch.Tensor:
        if pos_valid is not None and emb.dim() == 3:
            emb = emb * pos_valid[..., None].to(emb.dtype)
        if self.projection_dim:
            emb = getattr(self, f"{name}_proj")(emb)
            if pos_valid is not None and emb.dim() == 3:
                emb = emb * pos_valid[..., None].to(emb.dtype)
        if self.sequence_combiner and emb.dim() == 3:
            if pos_valid is not None:
                valid = pos_valid.sum(dim=-1, keepdim=True).to(emb.dtype)
            else:
                valid = torch.full((emb.shape[0], 1), emb.shape[1], dtype=emb.dtype,
                                   device=emb.device)
            emb = emb.sum(dim=1)
            if self.sequence_combiner == "mean":
                emb = emb / valid.clamp_min(1.0)
        return emb

    def compute(self, inputs, training=False, pad_mask=None, generator=None):
        out: TabularData = {}
        for name in self.tables:
            if name not in inputs:
                continue
            ids = inputs[name].long()
            emb = F.embedding(ids, getattr(self, f"{name}_pretrained"))
            emb = emb * (ids != 0)[..., None].to(emb.dtype)
            out[name] = self._finish(name, emb, (ids != 0) if ids.dim() == 2 else None)
        for name in self.precomputed_features:
            if name not in inputs:
                continue
            emb = inputs[name].float()
            pos_valid = emb.abs().sum(dim=-1) > 0 if emb.dim() == 3 else None
            out[name] = self._finish(name, emb, pos_valid)
        return out

    def feature_sizes(self) -> Dict[str, int]:
        sizes = {n: self.projection_dim or self.input_dims[n] for n in self.tables}
        for name in self.precomputed_features:
            dim = self.projection_dim or self.precomputed_dims.get(name, 0)
            if not dim:
                raise ValueError(
                    f"precomputed embedding column {name!r} needs its vector dim declared "
                    "for analytic output sizing: pass pretrained_output_dims={name: D} (or a "
                    "projection_dim) to from_schema")
            sizes[name] = dim
        return sizes


class PretrainedEmbeddingsInitializer:
    """A table initialiser, ``init(tensor, generator)``, that copies
    pre-trained weights (cardinality, dim) into the table; the rows the
    table has beyond them (``vocab_padding_multiple``) are zero. Row 0 is
    the padding item. ``trainable=False`` freezes the table."""

    def __init__(self, weight_matrix, trainable: bool = False):
        self.weight_matrix = np.asarray(weight_matrix)
        if self.weight_matrix.ndim != 2:
            raise ValueError(f"weight_matrix must be 2D (cardinality, dim), got "
                             f"{self.weight_matrix.shape}")
        self.trainable = trainable

    def __call__(self, t: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
        rows, dim = self.weight_matrix.shape
        if t.dim() != 2 or t.shape[1] != dim or t.shape[0] < rows:
            raise ValueError(f"pretrained weights {self.weight_matrix.shape} do not match "
                             f"table shape {tuple(t.shape)}")
        with torch.no_grad():
            t.zero_()
            t[:rows].copy_(torch.from_numpy(self.weight_matrix).to(t.dtype))
