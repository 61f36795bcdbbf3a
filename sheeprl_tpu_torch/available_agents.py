"""The algorithm registry as a table (counterpart of
``sheeprl_tpu/available_agents.py``): ``python -m
sheeprl_tpu_torch.available_agents`` lists every algorithm the port trains,
its module, entry point and whether it is decoupled."""

from __future__ import annotations

import importlib
from typing import List, Tuple


def agent_rows() -> List[Tuple[str, str, str, bool]]:
    """``(module, algorithm, entry point, decoupled)`` of every registered
    algorithm, in the registry's order."""
    from sheeprl_tpu_torch.utils.registry import PORTED_ALGORITHM_MODULES, algorithm_registry

    for module in PORTED_ALGORITHM_MODULES:
        importlib.import_module(module)
    return [(module, m["name"], m["entrypoint"], m["decoupled"])
            for module, metadata in algorithm_registry.items() for m in metadata]


def available_agents() -> None:
    rows = agent_rows()
    try:
        from rich.console import Console
        from rich.table import Table
    except ImportError:
        for module, name, entrypoint, decoupled in rows:
            print(f"{module}: {name} ({entrypoint}, decoupled={decoupled})")
        return
    table = Table(title="SheepRL-TPU Agents")
    for column in ("Module", "Algorithm", "Entrypoint", "Decoupled"):
        table.add_column(column)
    for module, name, entrypoint, decoupled in rows:
        table.add_row(module, name, entrypoint, str(decoupled))
    Console().print(table)


if __name__ == "__main__":
    available_agents()
