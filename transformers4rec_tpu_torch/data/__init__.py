from .loader import InMemoryDataLoader, SyntheticDataLoader
from .padding import pad_batch, pad_inputs, pad_ragged
from .synthetic import synthetic_data, synthetic_ecommerce_data_schema

__all__ = [
    "InMemoryDataLoader",
    "SyntheticDataLoader",
    "pad_batch",
    "pad_inputs",
    "pad_ragged",
    "synthetic_data",
    "synthetic_ecommerce_data_schema",
]
