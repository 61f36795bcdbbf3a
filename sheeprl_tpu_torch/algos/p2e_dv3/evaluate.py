"""Plan2Explore-DV3 evaluation (counterpart of
``sheeprl_tpu/algos/p2e_dv3/evaluate.py``): an exploration or a finetuning
checkpoint's task actor, evaluated as DreamerV3's policy is."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate_dreamer_v3
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def evaluate_p2e_dv3(runtime, cfg, state: Dict[str, Any]) -> float:
    """Returns the test episode's cumulative reward: the task actor (the
    exploration checkpoint's ``actor_task``, the finetuning one's
    ``actor``) on the world model."""
    task = {"world_model": state["world_model"], "actor": state["actor"] if "actor" in state else state["actor_task"]}
    return evaluate_dreamer_v3(runtime, cfg, task)
