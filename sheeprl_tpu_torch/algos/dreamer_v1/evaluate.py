"""DreamerV1 evaluation (counterpart of
``sheeprl_tpu/algos/dreamer_v1/evaluate.py``): one test episode of a
checkpoint's policy, sampled, its reward logged."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v2.evaluate import evaluate_dreamer
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="dreamer_v1")
def evaluate_dreamer_v1(runtime, cfg, state: Dict[str, Any]) -> float:
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import build_dreamer_v1_agent

    return evaluate_dreamer(build_dreamer_v1_agent, runtime, cfg, state)
