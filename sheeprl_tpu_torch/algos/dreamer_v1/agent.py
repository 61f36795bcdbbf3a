"""DreamerV1 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v1/agent.py``).

DreamerV1's latent state is a diagonal Gaussian: the representation and
transition heads emit ``(mean, raw std)``, ``std = softplus(raw) +
min_std``, and the state is the reparameterised sample ``mean + std *
noise`` on a pre-drawn standard-normal ``noise`` (drawn from the generator
without one).  The recurrent model is a plain GRU with a biased Dense and no
LayerNorm, so it takes the cell's plain path and launches no kernel (the
TPU kernel is the LayerNorm GRU's); the dynamic has no ``is_first`` reset.
Encoders, decoders, actor and critic are DreamerV3's modules with ELU dense
and ReLU conv activations, no LayerNorm, one-bin heads, the heads' default
initialization and the ``tanh_normal`` continuous actor."""

from __future__ import annotations

import math
from math import prod
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    TRAINED,
    Actor,
    Critic,
    PlayerDV3,
    RecurrentModel,
    WorldModel,
    _StochHead,
    init_weights,
    resolve_actor_cls,
)
from sheeprl_tpu_torch.parallel.dp import draw

PlayerDV1 = PlayerDV3


def gaussian_state(raw: torch.Tensor, min_std: float = 0.1, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, sample: bool = True):
    """``((mean, std), state)``: the head's output split into the mean and
    the raw std, ``std = softplus(raw) + min_std``, and the sample ``mean +
    std * noise`` (the mean without ``sample``)."""
    mean, std = torch.chunk(raw, 2, dim=-1)
    std = F.softplus(std) + min_std
    if not sample:
        return (mean, std), mean
    if noise is None:
        noise = draw(torch.randn, mean.shape, generator, dtype=mean.dtype, device=mean.device)
    return (mean, std), mean + std * noise.to(mean.dtype)


class GaussianRSSM(nn.Module):
    """The continuous-latent RSSM; states flow ``[..., stochastic]``."""

    def __init__(self, recurrent_state_size: int, stochastic_size: int, actions_dim: int, dense_units: int,
                 hidden_size: int, embedded_obs_size: int, min_std: float = 0.1, act: str = "elu"):
        super().__init__()
        self.min_std = min_std
        self.stochastic_size = stochastic_size
        self.recurrent_model = RecurrentModel(stochastic_size + actions_dim, recurrent_state_size, dense_units,
                                              act=act, layer_norm=False, gru_layer_norm=False)
        self.representation_model = _StochHead(recurrent_state_size + embedded_obs_size, hidden_size,
                                               2 * stochastic_size, act=act, layer_norm=False)
        self.transition_model = _StochHead(recurrent_state_size, hidden_size, 2 * stochastic_size, act=act,
                                           layer_norm=False)
        # not a parameter: the zero state's device and dtype
        self.register_buffer("initial_recurrent_state", torch.zeros(recurrent_state_size))

    def get_initial_states(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        h0 = self.initial_recurrent_state.expand(tuple(batch_shape) + self.initial_recurrent_state.shape)
        return h0, h0.new_zeros(tuple(batch_shape) + (self.stochastic_size,))

    def _representation(self, recurrent_state, embedded_obs, generator=None, noise=None):
        raw = self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1))
        return gaussian_state(raw, self.min_std, noise, generator)

    def _transition(self, recurrent_out, generator=None, sample_state: bool = True, noise=None):
        return gaussian_state(self.transition_model(recurrent_out), self.min_std, noise, generator, sample_state)

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, generator=None, noise=None):
        """One step of dynamic learning; ``noise`` is the ``(prior,
        posterior)`` standard-normal draws, each ``[B, stochastic]``.
        Returns ``(recurrent, posterior, prior, posterior_mean_std,
        prior_mean_std)``."""
        prior_noise, post_noise = noise if noise is not None else (None, None)
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        prior_mean_std, prior = self._transition(recurrent_state, generator, noise=prior_noise)
        posterior_mean_std, posterior = self._representation(recurrent_state, embedded_obs, generator, post_noise)
        return recurrent_state, posterior, prior, posterior_mean_std, prior_mean_std

    def imagination(self, stochastic_state, recurrent_state, actions, generator=None, noise=None):
        recurrent_state = self.recurrent_model(torch.cat([stochastic_state, actions], dim=-1), recurrent_state)
        _, prior = self._transition(recurrent_state, generator, noise=noise)
        return prior, recurrent_state


class WorldModelDV1(WorldModel):
    """DreamerV3's world model around the Gaussian RSSM: the same encoders,
    decoders and heads, laid out like the JAX package's tree."""

    def __init__(self, *, min_std: float = 0.1, **kwargs: Any):
        super().__init__(discrete_size=1, **kwargs)
        rssm = self.rssm
        recurrent_size = rssm.recurrent_model.cell.hidden_size
        embedded = rssm.representation_model.stack.dense[0].in_features - recurrent_size
        self.rssm = GaussianRSSM(recurrent_size, kwargs["stochastic_size"], kwargs["actions_dim"],
                                 kwargs["rssm_dense_units"], kwargs["rssm_hidden_size"], embedded, min_std,
                                 kwargs.get("dense_act", "elu"))

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, generator=None, noise=None):
        return self.rssm.dynamic(posterior, recurrent_state, action, embedded_obs, generator, noise)


class DV1Agent(NamedTuple):
    """DreamerV1's three trees (no target critic), as a checkpoint holds
    them, with the methods DreamerV3's loop reaches an agent through."""

    world_model: WorldModelDV1
    actor: Actor
    critic: Critic

    def optimizer_configs(self, cfg) -> Dict[str, Any]:
        return {name: cfg.algo[name] for name in TRAINED}

    def initial_moments(self, device: torch.device | str = "cpu") -> Dict[str, Any]:
        return {}

    def parameters_of(self, name: str) -> List[nn.Parameter]:
        return list(getattr(self, name).parameters())

    def optimizer_spec(self, name: str) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import param_spec

        return param_spec(*self)[name]

    def trees(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import to_flax

        return to_flax(*self)


def _latent_size(cfg) -> int:
    wm_cfg = cfg.algo.world_model
    return int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)


def make_actor(actions_dim: Sequence[int], is_continuous: bool, cfg) -> Actor:
    """DreamerV1's actor, uninitialized, on the CPU (the task's, and
    Plan2Explore-DV1's exploration actor)."""
    actor_cfg = cfg.algo.actor
    return resolve_actor_cls(actor_cfg)(_latent_size(cfg), actions_dim, is_continuous, distribution=cfg.distribution.type,
                 init_std=actor_cfg.init_std, min_std=actor_cfg.min_std, dense_units=actor_cfg.dense_units,
                 mlp_layers=actor_cfg.mlp_layers, unimix=0.0, action_clip=1.0, dense_act="elu", layer_norm=False,
                 default_continuous_dist="tanh_normal")


def make_critic(cfg) -> Critic:
    """DreamerV1's one-bin critic, uninitialized, on the CPU."""
    return Critic(_latent_size(cfg), cfg.algo.critic.dense_units, cfg.algo.critic.mlp_layers, 1, act="elu",
                  layer_norm=False)


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                agent_state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> DV1Agent:
    """The world model, actor and critic on ``device``, from ``agent_state``
    (a checkpoint's three flax trees, either package's) or from the seed."""
    wm_cfg = cfg.algo.world_model
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    cnn_decoder_keys, mlp_decoder_keys = list(cfg.algo.cnn_keys.decoder), list(cfg.algo.mlp_keys.decoder)
    world_model = WorldModelDV1(
        min_std=float(wm_cfg.min_std),
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
        learnable_initial_recurrent_state=False,
        dense_act="elu",
        cnn_act="relu",
        layer_norm=False,
        gru_layer_norm=False,
        symlog_inputs=False,
        hafner_heads=False,
    )
    actor, critic = make_actor(actions_dim, is_continuous, cfg), make_critic(cfg)
    init_weights(world_model, actor, critic, torch.Generator().manual_seed(int(cfg.seed or 0)), hafner_heads=False)
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import from_flax

        from_flax(agent_state, world_model, actor, critic)
    return DV1Agent(world_model.to(device), actor.to(device), critic.to(device))
