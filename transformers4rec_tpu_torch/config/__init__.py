from .transformer import (
    AlbertConfig,
    BertConfig,
    ElectraConfig,
    GPT2Config,
    LongformerConfig,
    ReformerConfig,
    RobertaConfig,
    T4RecConfig,
    TransfoXLConfig,
    XLNetConfig,
    transformer_registry,
)

__all__ = [
    "AlbertConfig",
    "BertConfig",
    "ElectraConfig",
    "GPT2Config",
    "LongformerConfig",
    "ReformerConfig",
    "RobertaConfig",
    "T4RecConfig",
    "TransfoXLConfig",
    "XLNetConfig",
    "transformer_registry",
]
