"""Plan2Explore-DV2 agent (counterpart of ``sheeprl_tpu/algos/p2e_dv2/agent.py``):
DreamerV2's four modules as the task's, an exploration actor, one
exploration critic and its target, and an ensemble of MLPs whose
disagreement on the next stochastic state is the intrinsic reward.

The ensemble is P2E-DV3's stacked one with DreamerV2's settings, as the JAX
package builds it: no LayerNorm (``algo.layer_norm``), so each hidden
Dense has its bias; silu, whatever ``ensembles.dense_act`` says; the head
truncated-normal.  The GRU with its LayerNorm runs the hand-written kernel
on the card in the dynamic scan and in both imaginations of a step.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, NamedTuple, Optional, Mapping, Sequence

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as build_dv2_agent, make_actor, make_critic
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Critic, WorldModel, init_weights
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensemble

#: the checkpoint keys of the agent's trees, the JAX package's
TREES = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration", "critic_exploration",
         "target_critic_exploration", "ensembles")


def optimizer_configs(agent, cfg) -> Dict[str, Any]:
    """Six optimizers, as the JAX package's exploration builds them: the
    world model's, the task actor's and critic's, the exploration actor's
    (``algo.actor``) and critic's (``algo.critic``), the ensembles'."""
    return {"world_model": cfg.algo.world_model, "actor_task": cfg.algo.actor, "critic_task": cfg.algo.critic,
            "actor_exploration": cfg.algo.actor, "critic_exploration": cfg.algo.critic, "ensembles": cfg.algo.ensembles}


def initial_moments(agent, device: torch.device | str = "cpu") -> Dict[str, Any]:
    return {}  # DreamerV2's and V1's steps keep no Moments


def parameters_of(agent, name: str) -> List[nn.Parameter]:
    return list(getattr(agent, name).parameters())


def optimizer_spec(agent, name: str) -> Any:
    from sheeprl_tpu_torch.interop.flax_params import p2e_dreamer_spec

    return p2e_dreamer_spec(agent)[name]


def trees(agent) -> Dict[str, Any]:
    """The trees as the JAX package's checkpoints hold them."""
    from sheeprl_tpu_torch.interop.flax_params import dump_trees, p2e_dreamer_spec

    return dump_trees(p2e_dreamer_spec(agent))


class P2EDV2Agent(NamedTuple):
    """Plan2Explore-DV2's modules under the JAX package's tree names."""

    world_model: WorldModel
    actor_task: Actor
    critic_task: Critic
    target_critic_task: Critic
    actor_exploration: Actor
    critic_exploration: Critic
    target_critic_exploration: Critic
    ensembles: Ensemble

    optimizer_configs = optimizer_configs
    initial_moments = initial_moments
    parameters_of = parameters_of
    optimizer_spec = optimizer_spec
    trees = trees


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> P2EDV2Agent:
    """DreamerV2's modules as the task's (from the seed), then from a
    generator seeded by ``cfg.seed + 29`` the exploration actor, critic (its
    target a copy) and the ensemble; all eight trees from ``state`` when
    given.  flax's random init cannot be reproduced here, so parity with the
    JAX package goes through converted weights."""
    dv2 = build_dv2_agent(actions_dim, is_continuous, cfg, obs_space, None, "cpu")
    generator = torch.Generator().manual_seed(int(cfg.seed or 0) + 29)
    actor_exploration, critic_exploration = make_actor(actions_dim, is_continuous, cfg), make_critic(cfg)
    init_weights(None, actor_exploration, critic_exploration, generator, hafner_heads=False)
    target_critic_exploration = copy.deepcopy(critic_exploration).requires_grad_(False)
    wm_cfg, ens_cfg = cfg.algo.world_model, cfg.algo.ensembles
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent = stoch_flat + int(wm_cfg.recurrent_model.recurrent_state_size)
    ensembles = Ensemble(int(ens_cfg.n), latent + int(sum(actions_dim)), stoch_flat, int(ens_cfg.dense_units),
                         int(ens_cfg.mlp_layers), layer_norm=bool(cfg.algo.get("layer_norm", False)))
    ensembles.reset_parameters(generator, zero_head=False)
    agent = P2EDV2Agent(*dv2, actor_exploration, critic_exploration, target_critic_exploration, ensembles)
    if state is not None:
        from sheeprl_tpu_torch.interop.flax_params import load_trees, p2e_dreamer_spec

        load_trees(p2e_dreamer_spec(agent), state)
    return P2EDV2Agent(*(m.to(device) for m in agent))
