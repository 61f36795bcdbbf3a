"""DreamerV2 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v2/agent.py``):
DreamerV3's modules with DreamerV2's settings, as the JAX package builds
them.  ELU activations, no LayerNorm outside the GRU (``algo.layer_norm``),
the GRU's Dense without a bias when it has its LayerNorm, no unimix, eps
1e-5, a zero initial recurrent state that is not learned, one-bin reward and
critic heads (a ``Normal(., 1)`` mean), no symlog of the vector inputs, the
heads' default initialization (``hafner_heads`` off) and the
``trunc_normal`` continuous actor.  The GRU with its LayerNorm runs the
hand-written kernel on the card (``models/blocks.py::LayerNormGRUCell``)."""

from __future__ import annotations

import copy
import math
from math import prod
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Agent, Critic, PlayerDV3, WorldModel, init_weights

PlayerDV2 = PlayerDV3

EPS = 1e-5


class DV2Agent(Agent):
    """DreamerV3's four trees; DreamerV2's step keeps no Moments."""

    def initial_moments(self, device: torch.device | str = "cpu") -> Dict[str, Any]:
        return {}


def _latent_size(cfg) -> int:
    wm_cfg = cfg.algo.world_model
    return int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(wm_cfg.recurrent_model.recurrent_state_size)


def make_actor(actions_dim: Sequence[int], is_continuous: bool, cfg) -> Actor:
    """DreamerV2's actor, uninitialized, on the CPU (the task's, and
    Plan2Explore-DV2's exploration actor)."""
    actor_cfg = cfg.algo.actor
    return Actor(_latent_size(cfg), actions_dim, is_continuous, distribution=cfg.distribution.type,
                 init_std=actor_cfg.init_std, min_std=actor_cfg.min_std, dense_units=actor_cfg.dense_units,
                 mlp_layers=actor_cfg.mlp_layers, unimix=0.0, action_clip=1.0, eps=EPS, dense_act="elu",
                 layer_norm=bool(cfg.algo.layer_norm), default_continuous_dist="trunc_normal")


def make_critic(cfg) -> Critic:
    """DreamerV2's one-bin critic, uninitialized, on the CPU."""
    critic_cfg = cfg.algo.critic
    return Critic(_latent_size(cfg), critic_cfg.dense_units, critic_cfg.mlp_layers, 1, EPS, "elu",
                  bool(cfg.algo.layer_norm))


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                agent_state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> DV2Agent:
    """The world model, actor, critic and target critic on ``device``, from
    ``agent_state`` (a checkpoint's four flax trees, either package's) or
    from the seed, the target critic a copy of the critic."""
    wm_cfg = cfg.algo.world_model
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    cnn_decoder_keys, mlp_decoder_keys = list(cfg.algo.cnn_keys.decoder), list(cfg.algo.mlp_keys.decoder)
    layer_norm = bool(cfg.algo.layer_norm)
    world_model = WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_input_channels=int(sum(prod(obs_space[k].shape[:-2]) for k in cnn_keys)),
        mlp_input_dim=int(sum(prod(obs_space[k].shape) for k in mlp_keys)),
        image_size=tuple(obs_space[cnn_keys[0]].shape[-2:]) if cnn_keys else (64, 64),
        channels_multiplier=wm_cfg.encoder.cnn_channels_multiplier,
        cnn_stages=int(math.log2(cfg.env.screen_size) - math.log2(4)) if cnn_keys else 4,
        encoder_dense_units=wm_cfg.encoder.dense_units,
        encoder_mlp_layers=wm_cfg.encoder.mlp_layers,
        recurrent_state_size=wm_cfg.recurrent_model.recurrent_state_size,
        stochastic_size=wm_cfg.stochastic_size,
        discrete_size=wm_cfg.discrete_size,
        actions_dim=int(sum(actions_dim)),
        rssm_dense_units=wm_cfg.recurrent_model.dense_units,
        rssm_hidden_size=wm_cfg.representation_model.hidden_size,
        cnn_decoder_keys=cnn_decoder_keys,
        cnn_decoder_channels=[int(prod(obs_space[k].shape[:-2])) for k in cnn_decoder_keys],
        mlp_decoder_keys=mlp_decoder_keys,
        mlp_output_dims=[int(prod(obs_space[k].shape)) for k in mlp_decoder_keys],
        decoder_dense_units=wm_cfg.observation_model.dense_units,
        decoder_mlp_layers=wm_cfg.observation_model.mlp_layers,
        reward_dense_units=wm_cfg.reward_model.dense_units,
        reward_mlp_layers=wm_cfg.reward_model.mlp_layers,
        reward_bins=1,
        continue_dense_units=wm_cfg.discount_model.dense_units,
        continue_mlp_layers=wm_cfg.discount_model.mlp_layers,
        unimix=0.0,
        eps=EPS,
        learnable_initial_recurrent_state=False,
        decoupled_rssm=False,
        dense_act="elu",
        cnn_act="elu",
        layer_norm=layer_norm,
        gru_layer_norm=bool(wm_cfg.recurrent_model.layer_norm),
        symlog_inputs=False,
        hafner_heads=False,
    )
    actor, critic = make_actor(actions_dim, is_continuous, cfg), make_critic(cfg)
    init_weights(world_model, actor, critic, torch.Generator().manual_seed(int(cfg.seed or 0)), hafner_heads=False)
    target_critic = copy.deepcopy(critic)
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import from_flax

        from_flax(agent_state, world_model, actor, critic, target_critic)
    target_critic.requires_grad_(False)
    return DV2Agent(world_model.to(device), actor.to(device), critic.to(device), target_critic.to(device))
