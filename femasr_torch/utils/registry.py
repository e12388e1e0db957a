"""Name -> constructor registry that wires a YAML `type:` to a network.

The port's copy of what it uses of femasr_tpu/utils/registry.py
(Registry: decorator registration, duplicate detection, lookup that names
what is available), with the one registry the port uses, ARCH_REGISTRY
(`models.build_network`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> object mapping with decorator-style registration."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None,
                 name: Optional[str] = None) -> Callable:
        """Register `obj` under `name` (its __name__ by default), or return
        a decorator that does so."""
        def do(o: Any) -> Any:
            key = name or o.__name__
            if key in self._obj_map:
                raise KeyError(f"An object named '{key}' was already "
                               f"registered in '{self._name}' registry!")
            self._obj_map[key] = o
            return o
        return do if obj is None else do(obj)

    def get(self, name: str) -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(f"No object named '{name}' found in "
                           f"'{self._name}' registry! Available: "
                           f"{sorted(self._obj_map)}")
        return ret


ARCH_REGISTRY = Registry('arch')
