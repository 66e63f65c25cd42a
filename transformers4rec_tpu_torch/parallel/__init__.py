from .sharded_embedding import (
    shard_table,
    sharded_ce_and_rank,
    sharded_embedding_lookup,
    sharded_softmax_ce,
    sharded_topk,
)

__all__ = [
    "shard_table",
    "sharded_ce_and_rank",
    "sharded_embedding_lookup",
    "sharded_softmax_ce",
    "sharded_topk",
]
