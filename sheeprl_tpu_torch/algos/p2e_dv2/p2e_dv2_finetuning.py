"""Plan2Explore-DV2 finetuning (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_finetuning.py``): DreamerV2's gradient
step through DreamerV3's loop (``_dreamer_main`` in its own order, the
sequential buffer, the target counter restarting at resume, as the JAX
finetuning runs it), started from an exploration checkpoint
(``checkpoint.exploration_ckpt_path``).

The world model and the task actor and critic (with its target) come from
the exploration run, with their optimizer states; the model and env fields
that must match it come from its archived ``config.yaml``; with
``buffer.load_from_exploration`` its replay too.  The player acts with the
exploration actor until the first gradient step, then with the task actor
(``algo.player.actor_type=task``: from the start).  A finetuning
checkpoint holds DreamerV2's four trees and ``actor_exploration``, as the
JAX package writes it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import DV2Agent, build_agent as build_dv2_agent, make_actor
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_train_step, unported_options
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Agent, Critic, WorldModel, init_weights
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _dreamer_main
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
    """DreamerV2's four modules, trained, and the exploration actor, which
    only acts."""

    world_model: WorldModel
    actor: Actor
    critic: Critic
    target_critic: Critic
    actor_exploration: Actor

    optimizer_configs = Agent.optimizer_configs
    initial_moments = DV2Agent.initial_moments
    parameters_of = Agent.parameters_of
    optimizer_spec = finetuning_optimizer_spec
    trees = finetuning_trees


def load_actor_exploration(actor_exploration: Actor, cfg, state: Optional[Mapping[str, Any]], seed_offset: int):
    """The exploration actor from ``state`` or, without one, from a
    generator seeded by ``cfg.seed + seed_offset``."""
    init_weights(None, actor_exploration, None, torch.Generator().manual_seed(int(cfg.seed or 0) + seed_offset),
                 hafner_heads=False)
    if state is not None:
        from sheeprl_tpu_torch.interop.flax_params import actor_spec, load_trees

        load_trees({"actor_exploration": actor_spec(actor_exploration)}, state)
    return actor_exploration


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> FinetuningAgent:
    """DreamerV2's agent and the exploration actor, from ``state``
    (:func:`finetuning_state`'s layout) or from the seed."""
    dv2 = build_dv2_agent(actions_dim, is_continuous, cfg, obs_space,
                          None if state is None else {k: state[k] for k in FinetuningAgent._fields[:4]}, "cpu")
    actor_exploration = load_actor_exploration(make_actor(actions_dim, is_continuous, cfg), cfg, state, 29)
    return FinetuningAgent(*(m.to(device) for m in (*dv2, actor_exploration)))


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The finetuning loop: DreamerV3's with DreamerV2's step, from the
    exploration checkpoint when not resuming."""
    apply_exploration_cfg(cfg, load_exploration_cfg(cfg))
    return _dreamer_main(
        runtime, cfg, build_agent, make_train_step,
        load_agent_state_fn=lambda runtime, cfg: finetuning_state(runtime.load(cfg.checkpoint.exploration_ckpt_path)),
        player_actor_fn=player_actor(cfg),
        unported_fn=lambda c: unported_options(c, "p2e_dv2_finetuning"),
    )
