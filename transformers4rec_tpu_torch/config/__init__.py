from .transformer import GPT2Config, T4RecConfig, XLNetConfig, transformer_registry

__all__ = ["GPT2Config", "T4RecConfig", "XLNetConfig", "transformer_registry"]
