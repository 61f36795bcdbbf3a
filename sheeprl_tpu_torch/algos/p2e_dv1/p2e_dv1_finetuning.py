"""Plan2Explore-DV1 finetuning (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``): DreamerV1's gradient
step through DreamerV3's loop (``_dreamer_main`` in its own order, the
sequential buffer, as the JAX finetuning runs it), started from an
exploration checkpoint (``checkpoint.exploration_ckpt_path``): P2E-DV2's
finetuning with DreamerV1's three trees, which have no target critic.  A
finetuning checkpoint holds them and ``actor_exploration``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent, WorldModelDV1, build_agent as build_dv1_agent, \
    make_actor
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Critic
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _dreamer_main
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning as p2e_dv2_ft
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import p2e_unported_options
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import (
    apply_exploration_cfg,
    finetuning_optimizer_spec,
    finetuning_state,
    finetuning_trees,
    load_exploration_cfg,
    player_actor,
)
from sheeprl_tpu_torch.utils.registry import register_algorithm


class FinetuningAgent(NamedTuple):
    """DreamerV1's three modules, trained, and the exploration actor, which
    only acts."""

    world_model: WorldModelDV1
    actor: Actor
    critic: Critic
    actor_exploration: Actor

    optimizer_configs = DV1Agent.optimizer_configs
    initial_moments = DV1Agent.initial_moments
    parameters_of = DV1Agent.parameters_of
    optimizer_spec = finetuning_optimizer_spec
    trees = finetuning_trees


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> FinetuningAgent:
    """DreamerV1's agent and the exploration actor, from ``state``
    (:func:`finetuning_state`'s layout) or from the seed."""
    dv1 = build_dv1_agent(actions_dim, is_continuous, cfg, obs_space,
                          None if state is None else {k: state[k] for k in FinetuningAgent._fields[:3]}, "cpu")
    actor_exploration = p2e_dv2_ft.load_actor_exploration(make_actor(actions_dim, is_continuous, cfg), cfg, state, 41)
    return FinetuningAgent(*(m.to(device) for m in (*dv1, actor_exploration)))


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The finetuning loop: DreamerV3's with DreamerV1's step, from the
    exploration checkpoint when not resuming."""
    apply_exploration_cfg(cfg, load_exploration_cfg(cfg))
    return _dreamer_main(
        runtime, cfg, build_agent, make_train_step,
        load_agent_state_fn=lambda runtime, cfg: finetuning_state(runtime.load(cfg.checkpoint.exploration_ckpt_path)),
        player_actor_fn=player_actor(cfg),
        unported_fn=lambda c: p2e_unported_options(c, "p2e_dv1_finetuning"),
    )
