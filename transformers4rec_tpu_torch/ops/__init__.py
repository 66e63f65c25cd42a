from .vocab import ce_rank, ce_rank_plain, fused_ce_and_rank, label_logits

__all__ = ["ce_rank", "ce_rank_plain", "fused_ce_and_rank", "label_logits"]
