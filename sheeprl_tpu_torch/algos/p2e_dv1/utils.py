"""Plan2Explore-DV1 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv1/utils.py``):
the metric keys (P2E-DV2's: the same entries) and the models a registry
would hold."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.p2e_dv2.utils import AGGREGATOR_KEYS  # noqa: F401  (the same keys)

MODELS_TO_REGISTER = {
    "world_model",
    "ensembles",
    "actor_exploration",
    "critic_exploration",
    "actor_task",
    "critic_task",
}
