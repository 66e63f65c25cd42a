"""Minimal name→class registry with ``parse`` dispatch.

Counterpart of ``transformers4rec_tpu/utils/registry.py``: masking schemes,
aggregations and transformer configs are found by name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Any] = {}

    def register(self, *names: str) -> Callable:
        def deco(obj):
            for n in names:
                key = n.lower()
                self._items[key] = obj
            return obj

        return deco

    def get(self, name: str, default=None):
        return self._items.get(name.lower(), default)

    def parse(self, name_or_obj):
        """Resolve a registered name → class; pass through instances/classes."""
        if isinstance(name_or_obj, str):
            key = name_or_obj.lower()
            if key not in self._items:
                raise KeyError(
                    f"{name_or_obj!r} not found in {self.name} registry; "
                    f"available: {sorted(self._items)}"
                )
            return self._items[key]
        return name_or_obj

    def keys(self):
        """The registered names."""
        return self._items.keys()
