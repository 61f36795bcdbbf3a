"""DroQ helpers (counterpart of ``sheeprl_tpu/algos/droq/utils.py``): the
metric keys; the flat observation and the test episode are SAC's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test  # noqa: F401

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}
MODELS_TO_REGISTER = {"agent"}
