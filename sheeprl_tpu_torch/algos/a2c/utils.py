"""A2C helpers (counterpart of ``sheeprl_tpu/algos/a2c/utils.py``): the
metric keys; the test episode is PPO's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.ppo.utils import test  # noqa: F401

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Grads/global_norm",
}
MODELS_TO_REGISTER = {"agent"}
