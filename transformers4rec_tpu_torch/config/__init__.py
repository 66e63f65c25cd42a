from .transformer import T4RecConfig, XLNetConfig, transformer_registry

__all__ = ["T4RecConfig", "XLNetConfig", "transformer_registry"]
