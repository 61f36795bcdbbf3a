"""Algorithm registry (counterpart of ``sheeprl_tpu/utils/registry.py``):
an algorithm's training module registers its entry point at import time,
and the CLI looks it up by name."""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional

#: module path -> [{name, entrypoint}]
algorithm_registry: Dict[str, List[Dict[str, Any]]] = {}
#: the training modules the port has; importing one registers it
PORTED_ALGORITHM_MODULES = ("sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",)


def register_algorithm() -> Callable:
    """Register ``fn`` as the entry point of the algorithm named after its
    module (``.../dreamer_v3/dreamer_v3.py`` -> ``dreamer_v3``)."""

    def inner(fn: Callable) -> Callable:
        module = fn.__module__
        entry = {"name": module.split(".")[-1], "entrypoint": fn.__name__}
        registered = algorithm_registry.setdefault(module, [])
        if entry not in registered:
            registered.append(entry)
        return fn

    return inner


def find_algorithm(name: str) -> Optional[Dict[str, Any]]:
    """``{module, name, entrypoint}`` of a ported algorithm, or None."""
    for module in PORTED_ALGORITHM_MODULES:
        importlib.import_module(module)
    for module, entries in algorithm_registry.items():
        for meta in entries:
            if meta["name"] == name:
                return {"module": module, **meta}
    return None
