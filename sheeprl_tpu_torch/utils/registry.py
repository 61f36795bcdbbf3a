"""Algorithm and evaluation registries (counterpart of
``sheeprl_tpu/utils/registry.py``): an algorithm's training module registers
its entry point at import time, its ``evaluate`` module its evaluation, and
the CLI looks them up by name."""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional

#: module path -> [{name, entrypoint, decoupled}]; ``decoupled`` marks the
#: player/trainer loops (``ppo_decoupled``, ``sac_decoupled``)
algorithm_registry: Dict[str, List[Dict[str, Any]]] = {}
evaluation_registry: Dict[str, List[Dict[str, Any]]] = {}
#: the modules the port has; importing one registers it
PORTED_ALGORITHM_MODULES = ("sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
                            "sheeprl_tpu_torch.algos.dreamer_v3_jepa.dreamer_v3_jepa",
                            "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
                            "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
                            "sheeprl_tpu_torch.algos.ppo.ppo", "sheeprl_tpu_torch.algos.ppo.ppo_decoupled",
                            "sheeprl_tpu_torch.algos.a2c.a2c", "sheeprl_tpu_torch.algos.sac.sac",
                            "sheeprl_tpu_torch.algos.sac.sac_decoupled", "sheeprl_tpu_torch.algos.droq.droq",
                            "sheeprl_tpu_torch.algos.sac_ae.sac_ae", "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
                            "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
                            "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
                            "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
                            "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
                            "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
                            "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning")
PORTED_EVALUATION_MODULES = ("sheeprl_tpu_torch.algos.dreamer_v3.evaluate",
                             "sheeprl_tpu_torch.algos.dreamer_v3_jepa.evaluate",
                             "sheeprl_tpu_torch.algos.p2e_dv3.evaluate",
                             "sheeprl_tpu_torch.algos.ppo.evaluate", "sheeprl_tpu_torch.algos.a2c.evaluate",
                             "sheeprl_tpu_torch.algos.sac.evaluate", "sheeprl_tpu_torch.algos.droq.evaluate",
                             "sheeprl_tpu_torch.algos.sac_ae.evaluate", "sheeprl_tpu_torch.algos.dreamer_v2.evaluate",
                             "sheeprl_tpu_torch.algos.dreamer_v1.evaluate",
                             "sheeprl_tpu_torch.algos.ppo_recurrent.evaluate",
                             "sheeprl_tpu_torch.algos.p2e_dv2.evaluate", "sheeprl_tpu_torch.algos.p2e_dv1.evaluate")


def _register(registry: Dict[str, List[Dict[str, Any]]], fn: Callable, name: str,
              decoupled: bool = False) -> Callable:
    entry = {"name": name, "entrypoint": fn.__name__, "decoupled": decoupled}
    registered = registry.setdefault(fn.__module__, [])
    if entry not in registered:
        registered.append(entry)
    return fn


def register_algorithm(decoupled: bool = False) -> Callable:
    """Register ``fn`` as the entry point of the algorithm named after its
    module (``.../dreamer_v3/dreamer_v3.py`` -> ``dreamer_v3``); ``decoupled``
    marks a player/trainer loop, which ``cli.check_configs`` holds to its
    own rules."""
    return lambda fn: _register(algorithm_registry, fn, fn.__module__.split(".")[-1], decoupled)


def register_evaluation(algorithms: str | List[str]) -> Callable:
    """Register ``fn`` as the evaluation of each algorithm named."""
    names = [algorithms] if isinstance(algorithms, str) else list(algorithms)

    def inner(fn: Callable) -> Callable:
        for name in names:
            _register(evaluation_registry, fn, name)
        return fn

    return inner


def _find(registry: Dict[str, List[Dict[str, Any]]], modules, name: str) -> Optional[Dict[str, Any]]:
    for module in modules:
        importlib.import_module(module)
    for module, entries in registry.items():
        for meta in entries:
            if meta["name"] == name:
                return {"module": module, **meta}
    return None


def find_algorithm(name: str) -> Optional[Dict[str, Any]]:
    """``{module, name, entrypoint, decoupled}`` of a ported algorithm, or None."""
    return _find(algorithm_registry, PORTED_ALGORITHM_MODULES, name)


def find_evaluation(name: str) -> Optional[Dict[str, Any]]:
    """``{module, name, entrypoint, decoupled}`` of a ported evaluation, or None."""
    return _find(evaluation_registry, PORTED_EVALUATION_MODULES, name)
