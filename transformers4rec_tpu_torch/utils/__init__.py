from .device import disable_tf32, module_device, resolve_device
from .registry import Registry

__all__ = ["Registry", "disable_tf32", "module_device", "resolve_device"]
