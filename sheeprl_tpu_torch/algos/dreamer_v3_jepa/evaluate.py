"""DreamerV3-JEPA evaluation (counterpart of
``sheeprl_tpu/algos/dreamer_v3_jepa/evaluate.py``): the JEPA heads act only
at train time, so a checkpoint's policy is DreamerV3's, evaluated as
DreamerV3's is."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate_dreamer_v3
from sheeprl_tpu_torch.utils.registry import register_evaluation

evaluate_dreamer_v3_jepa = register_evaluation(algorithms="dreamer_v3_jepa")(evaluate_dreamer_v3)
