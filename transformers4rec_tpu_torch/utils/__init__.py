from . import data_utils, examples_utils
from .device import disable_tf32, module_device, resolve_device
from .registry import Registry

__all__ = ["Registry", "data_utils", "disable_tf32", "examples_utils", "module_device",
           "resolve_device"]
