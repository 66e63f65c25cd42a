from .fused_adafactor import FusedAdafactor
from .sparse_update import label_embedding_params
from .vocab import (
    ce_bwd,
    ce_bwd_plain,
    ce_fwd,
    ce_fwd_plain,
    ce_rank,
    ce_rank_plain,
    fused_ce_and_rank,
    fused_softmax_ce,
    label_logits,
)

__all__ = [
    "FusedAdafactor",
    "ce_bwd",
    "ce_bwd_plain",
    "ce_fwd",
    "ce_fwd_plain",
    "ce_rank",
    "ce_rank_plain",
    "fused_ce_and_rank",
    "fused_softmax_ce",
    "label_embedding_params",
    "label_logits",
]
