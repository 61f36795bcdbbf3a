"""Plan2Explore-DV3 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv3/utils.py``):
the metric keys and the per-critic expansion of the generic ones."""

from __future__ import annotations

from typing import Sequence

from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS as DV3_AGGREGATOR_KEYS
from sheeprl_tpu_torch.utils.utils import dotdict

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/ensemble_loss",
    "Loss/policy_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Grads/world_model",
    "Grads/ensemble",
    "Grads/actor_exploration",
    "Grads/actor_task",
    "Grads/critic_task",
    # the generic per-exploration-critic keys; the exploration's main
    # expands them to `<key>_<critic name>`
    "Loss/value_loss_exploration",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/critic_exploration",
    "Rewards/intrinsic",
} | DV3_AGGREGATOR_KEYS

MODELS_TO_REGISTER = {
    "world_model",
    "ensembles",
    "actor_exploration",
    "actor_task",
    "critic_task",
    "target_critic_task",
    "critics_exploration",
    "moments_task",
    "moments_exploration",
}

GENERIC_CRITIC_METRICS = (
    "Loss/value_loss_exploration",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/critic_exploration",
    "Rewards/intrinsic",
)


def expand_exploration_metric_keys(cfg, critic_names: Sequence[str]) -> None:
    """Replace each generic exploration-critic metric of the aggregator's
    config with one per critic, ``<key>_<name>``."""
    metrics = dict(cfg.metric.aggregator.get("metrics", {}))
    for generic in GENERIC_CRITIC_METRICS:
        template = metrics.pop(generic, None)
        if template is None:
            continue
        for name in critic_names:
            metrics[f"{generic}_{name}"] = template
    cfg.metric.aggregator.metrics = dotdict(metrics)
