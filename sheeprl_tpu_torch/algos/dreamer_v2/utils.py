"""DreamerV2 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v2/utils.py``):
the metric keys, the models a registry would hold, the bootstrapped lambda
returns, and DreamerV3's observation staging and test episode."""

from __future__ import annotations

from typing import Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic"}


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          bootstrap: Optional[torch.Tensor] = None, horizon: int = 15,
                          lmbda: float = 0.95) -> torch.Tensor:
    """DreamerV2's lambda returns over ``[H, ...]`` with an explicit
    ``bootstrap`` (``[1, ...]``, zeros by default), the reverse scan of the
    JAX package."""
    if bootstrap is None:
        bootstrap = torch.zeros_like(values[-1:])
    next_values = torch.cat([values[1:], bootstrap], dim=0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    agg, out = bootstrap[0], []
    for t in reversed(range(inputs.shape[0])):
        agg = inputs[t] + continues[t] * lmbda * agg
        out.append(agg)
    return torch.stack(out[::-1])
