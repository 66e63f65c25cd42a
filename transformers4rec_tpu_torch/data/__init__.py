from .dataset import Dataset, ParquetDataset
from .loader import (
    InMemoryDataLoader,
    ParquetDataLoader,
    StreamingParquetDataLoader,
    SyntheticDataLoader,
    T4RecDataLoader,
    dataloader_registry,
)
from .packing import pack_sessions, packing_stats
from .padding import dense_to_ragged, pad_batch, pad_inputs, pad_ragged
from .synthetic import (
    generate_item_interactions,
    interactions_to_sessions,
    synthetic_data,
    synthetic_ecommerce_data_schema,
)
from .testing import (
    music_streaming_testing_data,
    tabular_sequence_testing_data,
    tabular_testing_data,
)

__all__ = [
    "music_streaming_testing_data",
    "tabular_sequence_testing_data",
    "tabular_testing_data",
    "Dataset",
    "InMemoryDataLoader",
    "ParquetDataset",
    "ParquetDataLoader",
    "StreamingParquetDataLoader",
    "SyntheticDataLoader",
    "T4RecDataLoader",
    "dataloader_registry",
    "dense_to_ragged",
    "pack_sessions",
    "packing_stats",
    "pad_batch",
    "pad_inputs",
    "pad_ragged",
    "generate_item_interactions",
    "interactions_to_sessions",
    "synthetic_data",
    "synthetic_ecommerce_data_schema",
]
