from .base import SequentialBlock, TransformerBlock
from .transformer import (
    MultiHeadAttention,
    RelativePositionBias,
    TransformerEncoder,
    TransformerLayer,
    make_attention_bias,
)

__all__ = [
    "MultiHeadAttention",
    "RelativePositionBias",
    "SequentialBlock",
    "TransformerBlock",
    "TransformerEncoder",
    "TransformerLayer",
    "make_attention_bias",
]
