"""Plan2Explore-DV1 agent (counterpart of ``sheeprl_tpu/algos/p2e_dv1/agent.py``):
DreamerV1's three modules as the task's, an exploration actor, one
exploration critic (DreamerV1 has no target critics), and an ensemble of
MLPs whose disagreement on the next observation embedding is the intrinsic
reward.

The ensemble is P2E-DV3's stacked one as the JAX package builds it for
DreamerV1: no LayerNorm, so each hidden Dense has its bias; DreamerV1's
dense activation (``algo.dense_act``, elu); the head truncated-normal; its
output as wide as the encoder's embedding, probed from the world model.
The GRU has no LayerNorm: nothing on this path launches a kernel.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import WorldModelDV1, build_agent as build_dv1_agent, make_actor, \
    make_critic
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Critic, init_weights
from sheeprl_tpu_torch.algos.p2e_dv2 import agent as p2e_dv2_agent
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensemble

#: the checkpoint keys of the agent's trees, the JAX package's
TREES = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")


class P2EDV1Agent(NamedTuple):
    """Plan2Explore-DV1's modules under the JAX package's tree names, with
    P2E-DV2's six optimizers."""

    world_model: WorldModelDV1
    actor_task: Actor
    critic_task: Critic
    actor_exploration: Actor
    critic_exploration: Critic
    ensembles: Ensemble

    optimizer_configs = p2e_dv2_agent.optimizer_configs
    initial_moments = p2e_dv2_agent.initial_moments
    parameters_of = p2e_dv2_agent.parameters_of
    optimizer_spec = p2e_dv2_agent.optimizer_spec
    trees = p2e_dv2_agent.trees


@torch.no_grad()
def embedding_size(world_model: WorldModelDV1, cfg, obs_space) -> int:
    """The encoder's output width, probed on a zero observation as the JAX
    package probes it: the ensemble's target width."""
    sample = {k: torch.zeros((1,) + tuple(obs_space[k].shape)) for k in cfg.algo.cnn_keys.encoder}
    sample.update({k: torch.zeros((1, int(torch.Size(obs_space[k].shape).numel()))) for k in cfg.algo.mlp_keys.encoder})
    return int(world_model.encode(sample).shape[-1])


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> P2EDV1Agent:
    """DreamerV1's modules as the task's (from the seed), then from a
    generator seeded by ``cfg.seed + 41`` the exploration actor and critic
    and the ensemble; all six trees from ``state`` when given."""
    dv1 = build_dv1_agent(actions_dim, is_continuous, cfg, obs_space, None, "cpu")
    generator = torch.Generator().manual_seed(int(cfg.seed or 0) + 41)
    actor_exploration, critic_exploration = make_actor(actions_dim, is_continuous, cfg), make_critic(cfg)
    init_weights(None, actor_exploration, critic_exploration, generator, hafner_heads=False)
    wm_cfg, ens_cfg = cfg.algo.world_model, cfg.algo.ensembles
    latent = int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    ensembles = Ensemble(int(ens_cfg.n), latent + int(sum(actions_dim)), embedding_size(dv1.world_model, cfg, obs_space),
                         int(ens_cfg.dense_units), int(ens_cfg.mlp_layers), act=str(cfg.algo.dense_act),
                         layer_norm=False)
    ensembles.reset_parameters(generator, zero_head=False)
    agent = P2EDV1Agent(*dv1, actor_exploration, critic_exploration, ensembles)
    if state is not None:
        from sheeprl_tpu_torch.interop.flax_params import load_trees, p2e_dreamer_spec

        load_trees(p2e_dreamer_spec(agent), state)
    return P2EDV1Agent(*(m.to(device) for m in agent))
