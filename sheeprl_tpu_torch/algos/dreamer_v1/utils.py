"""DreamerV1 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v1/utils.py``):
the metric keys, the models a registry would hold, DreamerV1's lambda
targets, and DreamerV3's observation staging and test episode."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.utils import AGGREGATOR_KEYS  # noqa: F401  (the same keys)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401

MODELS_TO_REGISTER = {"world_model", "actor", "critic"}


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          last_values: torch.Tensor, horizon: int = 15, lmbda: float = 0.95) -> torch.Tensor:
    """DreamerV1's lambda targets over ``horizon - 1`` steps: the last step
    bootstraps the whole ``last_values`` (no ``1 - lambda``)."""
    next_vals = torch.cat([values[1 : horizon - 1] * (1 - lmbda), last_values[None]], dim=0)
    agg, out = torch.zeros_like(last_values), []
    for t in reversed(range(horizon - 1)):
        agg = rewards[t] + next_vals[t] * continues[t] + lmbda * continues[t] * agg
        out.append(agg)
    return torch.stack(out[::-1])
