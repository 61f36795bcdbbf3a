"""Plan2Explore-DV2 evaluation (counterpart of
``sheeprl_tpu/algos/p2e_dv2/evaluate.py``): an exploration or a finetuning
checkpoint's task actor, evaluated as DreamerV2's policy is."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v2.evaluate import evaluate_dreamer
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["p2e_dv2_exploration", "p2e_dv2_finetuning"])
def evaluate_p2e_dv2(runtime, cfg, state: Dict[str, Any]) -> float:
    """Returns the test episode's cumulative reward: the task actor (the
    exploration checkpoint's ``actor_task``, the finetuning one's ``actor``)
    on the world model."""
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_dreamer_v2_agent

    finetuned = "actor" in state
    task = {"world_model": state["world_model"], "actor": state["actor" if finetuned else "actor_task"],
            "critic": state["critic" if finetuned else "critic_task"],
            "target_critic": state["target_critic" if finetuned else "target_critic_task"]}
    return evaluate_dreamer(build_dreamer_v2_agent, runtime, cfg, task)
