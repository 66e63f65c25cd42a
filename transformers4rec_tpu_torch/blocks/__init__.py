from .base import MLPBlock, SequentialBlock, TransformerBlock, check_masking_compat
from .transformer import (
    MultiHeadAttention,
    RelativePositionBias,
    TransformerEncoder,
    TransformerLayer,
    make_attention_bias,
    make_extra_bias,
)

__all__ = [
    "MLPBlock",
    "MultiHeadAttention",
    "RelativePositionBias",
    "SequentialBlock",
    "TransformerBlock",
    "TransformerEncoder",
    "TransformerLayer",
    "check_masking_compat",
    "make_attention_bias",
    "make_extra_bias",
]
