"""The distribution layer: the ('data', 'model') layout of ranks
(``mesh``) and the vocab-parallel item table (``sharded_embedding``).
Ported from the JAX package's ``parallel``: data parallelism over 'data',
row-sharded tables over 'model', the sharded CE, ranks, top-k, scores and
lookup (the row gather); the trainer, the sparse step and
``serving.sharded`` build on them."""

from .mesh import MIN_ROWS_TO_SHARD, Mesh, make_mesh, process_data_stripe, shards_rows
from .sharded_embedding import (
    shard_table,
    sharded_ce_and_rank,
    sharded_embedding_lookup,
    sharded_scores,
    sharded_softmax_ce,
    sharded_topk,
)

__all__ = [
    "MIN_ROWS_TO_SHARD",
    "Mesh",
    "make_mesh",
    "process_data_stripe",
    "shard_table",
    "sharded_ce_and_rank",
    "sharded_embedding_lookup",
    "sharded_scores",
    "sharded_softmax_ce",
    "sharded_topk",
    "shards_rows",
]
