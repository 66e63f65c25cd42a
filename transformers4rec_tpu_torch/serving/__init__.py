from .export import InferenceRunner, export_model
from .server import DynamicBatcher, ServingServer

__all__ = ["DynamicBatcher", "InferenceRunner", "ServingServer", "export_model"]
