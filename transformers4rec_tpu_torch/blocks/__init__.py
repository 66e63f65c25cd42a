from .base import (
    Block,
    MLPBlock,
    RNNBlock,
    SequentialBlock,
    TransformerBlock,
    check_masking_compat,
)
from .transformer import (
    LSHSelfAttention,
    MultiHeadAttention,
    RelativePositionBias,
    TransformerEncoder,
    TransformerLayer,
    make_attention_bias,
    make_extra_bias,
)

__all__ = [
    "Block",
    "LSHSelfAttention",
    "MLPBlock",
    "MultiHeadAttention",
    "RNNBlock",
    "RelativePositionBias",
    "SequentialBlock",
    "TransformerBlock",
    "TransformerEncoder",
    "TransformerLayer",
    "check_masking_compat",
    "make_attention_bias",
    "make_extra_bias",
]
