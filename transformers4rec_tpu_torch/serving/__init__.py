from .export import InferenceRunner, export_model
from .server import DynamicBatcher, ServingServer
from .sharded import ShardedInferenceRunner

__all__ = ["DynamicBatcher", "InferenceRunner", "ServingServer", "ShardedInferenceRunner",
           "export_model"]
