"""DreamerV3 agent, the part a policy server runs (counterpart of
``sheeprl_tpu/algos/dreamer_v3/agent.py``).

Ported: the dense stack, the CNN and MLP encoders, the recurrent model, the
RSSM's initial states, representation and transition, the world model's
``encode``/``initial_states``/``representation``/``recurrent_step``, the
actor's ``act`` for discrete heads and the continuous ``scaled_normal`` head,
``build_agent`` and ``PlayerDV3``.  The decoders, the reward and continue
heads, the critic and ``MinedojoActor`` come with the training slice
(ROADMAP.md, Queue 1).

Layouts follow the JAX package at every public function: observations are
CHW, stochastic states flat ``[..., stochastic * discrete]``.  The conv
stack runs NCHW and permutes to NHWC before its flatten, so the embedding
has the JAX package's (h, w, c) order and converted weights line up.

Sampling takes optional pre-drawn noise (``compute_stochastic_state``'s and
the discrete heads' Gumbel noise, the continuous head's standard normal):
``jax.random.categorical(k, l)`` is ``argmax(l + gumbel(k, l.shape))``, so a
test that feeds both packages the same draws compares them exactly.
Without noise, draws come from the ``torch.Generator`` passed in.
"""

from __future__ import annotations

import math
from math import prod
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.models.blocks import LayerNormChannelLast, LayerNormGRUCell, get_activation
from sheeprl_tpu_torch.ops.numerics import symlog

_NOT_PORTED = "not ported yet: see ROADMAP.md Queue 1"


def gumbel_like(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise shaped like ``x``, from ``generator``."""
    u = torch.rand(x.shape, dtype=x.dtype, device=x.device, generator=generator)
    tiny = torch.finfo(x.dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)).clamp_min(tiny))


class DenseStack(nn.Module):
    """[Linear(no bias iff LN) -> LayerNorm(eps)? -> act] x layers."""

    def __init__(self, in_features: int, units: int, layers: int, eps: float = 1e-3, act: str = "silu",
                 layer_norm: bool = True):
        super().__init__()
        self.act = get_activation(act)
        self.dense = nn.ModuleList(
            nn.Linear(in_features if i == 0 else units, units, bias=not layer_norm) for i in range(layers)
        )
        self.norms = nn.ModuleList(nn.LayerNorm(units, eps=eps) for _ in range(layers)) if layer_norm else None
        self.out_features = units if layers else in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
        return x


class CNNEncoderDV3(nn.Module):
    """4-stage stride-2 conv encoder.  Input is the channel-concat of the pixel
    keys in CHW; the output is flattened in (h, w, c) order."""

    def __init__(self, keys: Sequence[str], in_channels: int, channels_multiplier: int, stages: int = 4,
                 eps: float = 1e-3, act: str = "silu", layer_norm: bool = True):
        super().__init__()
        self.keys = tuple(keys)
        self.act = get_activation(act)
        channels = [in_channels] + [(2**i) * channels_multiplier for i in range(stages)]
        self.convs = nn.ModuleList(
            nn.Conv2d(channels[i], channels[i + 1], 4, stride=2, padding=1, bias=not layer_norm)
            for i in range(stages)
        )
        self.norms = (
            nn.ModuleList(LayerNormChannelLast(channels[i + 1], eps=eps) for i in range(stages)) if layer_norm else None
        )

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-3)
        lead = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:]))
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
        # NCHW -> NHWC before the flatten: the representation model's first
        # Dense consumes the JAX package's (h, w, c) order
        return x.permute(0, 2, 3, 1).reshape(tuple(lead) + (-1,))


class MLPEncoderDV3(nn.Module):
    """Symlog-input dense encoder."""

    def __init__(self, keys: Sequence[str], input_dim: int, dense_units: int, mlp_layers: int, eps: float = 1e-3,
                 symlog_inputs: bool = True, act: str = "silu", layer_norm: bool = True):
        super().__init__()
        self.keys = tuple(keys)
        self.symlog_inputs = symlog_inputs
        self.stack = DenseStack(input_dim, dense_units, mlp_layers, eps, act, layer_norm)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([symlog(obs[k]) if self.symlog_inputs else obs[k] for k in self.keys], dim=-1)
        return self.stack(x)


class RecurrentModel(nn.Module):
    """Dense projection + LayerNorm-GRU."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int, eps: float = 1e-3,
                 act: str = "silu", layer_norm: bool = True, gru_layer_norm: bool = True):
        super().__init__()
        self.stack = DenseStack(input_size, dense_units, 1, eps, act, layer_norm)
        self.cell = LayerNormGRUCell(
            dense_units, recurrent_state_size, use_bias=not gru_layer_norm, layer_norm=gru_layer_norm, norm_eps=eps
        )

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.cell(recurrent_state, self.stack(x))


def _unimix(logits: torch.Tensor, discrete: int, unimix: float) -> torch.Tensor:
    """Uniform mix on the per-variable categorical logits."""
    shape = logits.shape
    logits = logits.reshape(tuple(shape[:-1]) + (-1, discrete))
    if unimix > 0.0:
        probs = torch.softmax(logits, dim=-1)
        probs = (1 - unimix) * probs + unimix * (torch.ones_like(probs) / discrete)
        logits = torch.log(probs)
    return logits.reshape(shape)


def compute_stochastic_state(
    logits: torch.Tensor,
    discrete: int,
    generator: Optional[torch.Generator] = None,
    sample: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Straight-through sample of the ``[stoch, discrete]`` categorical block,
    returned flattened.  ``noise`` is Gumbel noise shaped
    ``[..., stoch, discrete]``; without it the draw comes from ``generator``."""
    shape = logits.shape
    logits = logits.reshape(tuple(shape[:-1]) + (-1, discrete))
    if sample:
        if noise is None:
            noise = gumbel_like(logits, generator)
        idx = torch.argmax(logits + noise.reshape(logits.shape), dim=-1)
        hard = F.one_hot(idx, discrete).to(logits.dtype)
        probs = torch.softmax(logits, dim=-1)
        out = hard + probs - probs.detach()  # straight-through
    else:
        out = F.one_hot(torch.argmax(logits, dim=-1), discrete).to(logits.dtype)
    return out.reshape(shape)


class _StochHead(nn.Module):
    """Hidden dense stack + linear head to the stochastic logits."""

    def __init__(self, in_features: int, hidden_size: int, out_size: int, eps: float = 1e-3, act: str = "silu",
                 layer_norm: bool = True):
        super().__init__()
        self.stack = DenseStack(in_features, hidden_size, 1, eps, act, layer_norm)
        self.head = nn.Linear(hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.stack(x))


class RSSM(nn.Module):
    """Recurrent State-Space Model; stochastic states flow flattened."""

    def __init__(self, recurrent_state_size: int, stochastic_size: int, discrete_size: int, actions_dim: int,
                 dense_units: int, hidden_size: int, embedded_obs_size: int, unimix: float = 0.01,
                 eps: float = 1e-3, learnable_initial_recurrent_state: bool = True, decoupled: bool = False,
                 act: str = "silu", layer_norm: bool = True, gru_layer_norm: bool = True):
        super().__init__()
        stoch_flat = stochastic_size * discrete_size
        self.discrete_size = discrete_size
        self.unimix = unimix
        self.decoupled = decoupled
        self.tanh_initial_state = learnable_initial_recurrent_state
        self.recurrent_model = RecurrentModel(
            stoch_flat + actions_dim, recurrent_state_size, dense_units, eps, act, layer_norm, gru_layer_norm
        )
        repr_in = embedded_obs_size if decoupled else recurrent_state_size + embedded_obs_size
        self.representation_model = _StochHead(repr_in, hidden_size, stoch_flat, eps, act, layer_norm)
        self.transition_model = _StochHead(recurrent_state_size, hidden_size, stoch_flat, eps, act, layer_norm)
        init = torch.zeros(recurrent_state_size)
        if learnable_initial_recurrent_state:
            self.initial_recurrent_state = nn.Parameter(init)
        else:
            self.register_buffer("initial_recurrent_state", init)

    def get_initial_states(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        h0 = self.initial_recurrent_state
        h0 = torch.tanh(h0) if self.tanh_initial_state else h0
        h0 = h0.expand(tuple(batch_shape) + h0.shape)
        logits = _unimix(self.transition_model(h0), self.discrete_size, self.unimix)
        return h0, compute_stochastic_state(logits, self.discrete_size, sample=False)

    def _representation(self, recurrent_state, embedded_obs, generator=None, noise=None):
        inp = embedded_obs if self.decoupled else torch.cat([recurrent_state, embedded_obs], dim=-1)
        logits = _unimix(self.representation_model(inp), self.discrete_size, self.unimix)
        return logits, compute_stochastic_state(logits, self.discrete_size, generator, noise=noise)

    def _transition(self, recurrent_out, generator=None, sample_state: bool = True, noise=None):
        logits = _unimix(self.transition_model(recurrent_out), self.discrete_size, self.unimix)
        return logits, compute_stochastic_state(logits, self.discrete_size, generator, sample_state, noise)


class WorldModel(nn.Module):
    """The world model's encoders and RSSM (the parts a policy step runs)."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_input_channels: int, mlp_input_dim: int,
                 image_size: Tuple[int, int], channels_multiplier: int, cnn_stages: int, encoder_dense_units: int,
                 encoder_mlp_layers: int, recurrent_state_size: int, stochastic_size: int, discrete_size: int,
                 actions_dim: int, rssm_dense_units: int, rssm_hidden_size: int, unimix: float = 0.01,
                 eps: float = 1e-3, learnable_initial_recurrent_state: bool = True, decoupled_rssm: bool = False,
                 dense_act: str = "silu", cnn_act: str = "silu", layer_norm: bool = True,
                 gru_layer_norm: bool = True, symlog_inputs: bool = True):
        super().__init__()
        self.decoupled_rssm = decoupled_rssm
        self.cnn_encoder = (
            CNNEncoderDV3(cnn_keys, cnn_input_channels, channels_multiplier, cnn_stages, eps, cnn_act, layer_norm)
            if cnn_keys
            else None
        )
        self.mlp_encoder = (
            MLPEncoderDV3(mlp_keys, mlp_input_dim, encoder_dense_units, encoder_mlp_layers, eps, symlog_inputs,
                          dense_act, layer_norm)
            if mlp_keys
            else None
        )
        embedded = 0
        if cnn_keys:
            embedded += (2 ** (cnn_stages - 1)) * channels_multiplier * (image_size[0] // (2**cnn_stages)) * (
                image_size[1] // (2**cnn_stages)
            )
        if mlp_keys:
            embedded += encoder_dense_units
        self.rssm = RSSM(
            recurrent_state_size, stochastic_size, discrete_size, actions_dim, rssm_dense_units, rssm_hidden_size,
            embedded, unimix, eps, learnable_initial_recurrent_state, decoupled_rssm, dense_act, layer_norm,
            gru_layer_norm,
        )

    def encode(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs))
        return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]

    def initial_states(self, batch_shape: Sequence[int]):
        return self.rssm.get_initial_states(batch_shape)

    def representation(self, recurrent_state, embedded_obs, generator=None, noise=None):
        return self.rssm._representation(recurrent_state, embedded_obs, generator, noise)

    def recurrent_step(self, stochastic, actions, recurrent_state):
        return self.rssm.recurrent_model(torch.cat([stochastic, actions], dim=-1), recurrent_state)


class Actor(nn.Module):
    """DV3 actor: dense backbone + one head per discrete sub-action (unimix +
    straight-through) or one (mean, std) head for the continuous
    ``scaled_normal`` distribution."""

    def __init__(self, latent_state_size: int, actions_dim: Sequence[int], is_continuous: bool,
                 distribution: str = "auto", init_std: float = 2.0, min_std: float = 0.1, max_std: float = 1.0,
                 dense_units: int = 1024, mlp_layers: int = 5, unimix: float = 0.01, action_clip: float = 1.0,
                 eps: float = 1e-3, dense_act: str = "silu", layer_norm: bool = True):
        super().__init__()
        dist = distribution.lower()
        if dist not in ("auto", "normal", "tanh_normal", "discrete", "scaled_normal", "trunc_normal"):
            raise ValueError(f"Invalid actor distribution: {dist}")
        if dist == "auto":
            dist = "scaled_normal" if is_continuous else "discrete"
        if dist not in ("discrete", "scaled_normal"):
            raise NotImplementedError(f"actor distribution {dist!r} is {_NOT_PORTED}")
        self.dist = dist
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = is_continuous
        self.init_std, self.min_std, self.max_std = init_std, min_std, max_std
        self.unimix = unimix
        self.action_clip = action_clip
        self.model = DenseStack(latent_state_size, dense_units, mlp_layers, eps, dense_act, layer_norm)
        width = self.model.out_features
        if is_continuous:
            self.heads = nn.ModuleList([nn.Linear(width, sum(self.actions_dim) * 2)])
        else:
            self.heads = nn.ModuleList(nn.Linear(width, d) for d in self.actions_dim)

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        """The raw head outputs."""
        x = self.model(state)
        return [h(x) for h in self.heads]

    def act(
        self,
        state: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Sample (or take the mode of) the actions, concatenated over heads.
        ``noise`` holds one tensor per head: Gumbel noise shaped like each
        discrete head's logits, or the standard normal draw for the
        continuous head."""
        pre_dist = self(state)
        if self.is_continuous:
            mean, std = torch.chunk(pre_dist[0], 2, dim=-1)
            std = (self.max_std - self.min_std) * torch.sigmoid(std + self.init_std) + self.min_std
            mean = torch.tanh(mean)
            if greedy:
                actions = mean
            else:
                eps = noise[0] if noise is not None else torch.randn(
                    mean.shape, dtype=mean.dtype, device=mean.device, generator=generator
                )
                actions = mean + std * eps
            if self.action_clip > 0.0:
                clip = torch.full_like(actions, self.action_clip)
                actions = actions * (clip / torch.maximum(clip, torch.abs(actions))).detach()
            return actions
        outs = []
        for i, logits in enumerate(pre_dist):
            logits = _unimix(logits, logits.shape[-1], self.unimix)
            if greedy:
                one_hot = F.one_hot(torch.argmax(logits, dim=-1), logits.shape[-1]).to(logits.dtype)
            else:
                gumbel = noise[i] if noise is not None else gumbel_like(logits, generator)
                hard = F.one_hot(torch.argmax(logits + gumbel, dim=-1), logits.shape[-1]).to(logits.dtype)
                probs = torch.softmax(logits, dim=-1)
                one_hot = hard + probs - probs.detach()
            outs.append(one_hot)
        return torch.cat(outs, dim=-1)


def _trunc_normal_fan_avg_(weight: torch.Tensor, fan_in: int, fan_out: int, generator: torch.Generator) -> None:
    # variance_scaling(1.0, "fan_avg", "truncated_normal"): the 0.8796 rescales
    # a [-2, 2]-truncated standard normal back to unit variance
    std = math.sqrt(1.0 / ((fan_in + fan_out) / 2.0)) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _uniform_fan_avg_(weight: torch.Tensor, fan_in: int, fan_out: int, generator: torch.Generator) -> None:
    limit = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
    nn.init.uniform_(weight, -limit, limit, generator=generator)


@torch.no_grad()
def init_weights(world_model: WorldModel, actor: Actor, generator: torch.Generator) -> None:
    """Hafner initialization from a seeded generator: truncated-normal
    fan-avg for every dense and conv kernel, uniform fan-avg for the
    stochastic-state and actor heads, zero biases, unit LayerNorm scales."""
    heads = {id(world_model.rssm.representation_model.head), id(world_model.rssm.transition_model.head)}
    heads.update(id(h) for h in actor.heads)
    for module in list(world_model.modules()) + list(actor.modules()):
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            w = module.weight
            receptive = prod(w.shape[2:]) if w.dim() > 2 else 1
            fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
            (_uniform_fan_avg_ if id(module) in heads else _trunc_normal_fan_avg_)(w, fan_in, fan_out, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    agent_state: Optional[Mapping[str, Any]] = None,
    device: torch.device | str = "cpu",
) -> Tuple[WorldModel, Actor]:
    """Build the world model and actor in eval mode on ``device``.  Weights
    come from ``agent_state`` when given (a checkpoint's
    ``{"world_model": {"params": ...}, "actor": {"params": ...}, ...}`` in
    the JAX package's layout), else from ``init_weights`` seeded with
    ``cfg.seed``."""
    wm_cfg = cfg.algo.world_model
    actor_cfg = cfg.algo.actor
    eps = float(cfg.algo.mlp_layer_norm.kw.get("eps", 1e-3)) if cfg.algo.get("mlp_layer_norm") else 1e-3
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    image_size = tuple(obs_space[cnn_keys[0]].shape[-2:]) if cnn_keys else (64, 64)
    cnn_stages = int(math.log2(cfg.env.screen_size) - math.log2(4)) if cnn_keys else 4
    recurrent_state_size = wm_cfg.recurrent_model.recurrent_state_size
    stochastic_size = wm_cfg.stochastic_size
    discrete_size = wm_cfg.discrete_size
    world_model = WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_input_channels=int(sum(prod(obs_space[k].shape[:-2]) for k in cnn_keys)),
        mlp_input_dim=int(sum(prod(obs_space[k].shape) for k in mlp_keys)),
        image_size=image_size,
        channels_multiplier=wm_cfg.encoder.cnn_channels_multiplier,
        cnn_stages=cnn_stages,
        encoder_dense_units=wm_cfg.encoder.dense_units,
        encoder_mlp_layers=wm_cfg.encoder.mlp_layers,
        recurrent_state_size=recurrent_state_size,
        stochastic_size=stochastic_size,
        discrete_size=discrete_size,
        actions_dim=int(sum(actions_dim)),
        rssm_dense_units=wm_cfg.recurrent_model.dense_units,
        rssm_hidden_size=wm_cfg.representation_model.hidden_size,
        unimix=cfg.algo.unimix,
        eps=eps,
        learnable_initial_recurrent_state=wm_cfg.learnable_initial_recurrent_state,
        decoupled_rssm=wm_cfg.decoupled_rssm,
    )
    actor = Actor(
        latent_state_size=stochastic_size * discrete_size + recurrent_state_size,
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        distribution=cfg.distribution.type,
        init_std=actor_cfg.init_std,
        min_std=actor_cfg.min_std,
        max_std=actor_cfg.get("max_std", 1.0),
        dense_units=actor_cfg.dense_units,
        mlp_layers=actor_cfg.mlp_layers,
        unimix=cfg.algo.unimix,
        action_clip=actor_cfg.action_clip,
        eps=eps,
    )
    generator = torch.Generator().manual_seed(int(cfg.seed or 0))
    init_weights(world_model, actor, generator)
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import from_flax

        from_flax(agent_state, world_model, actor)
    return world_model.to(device).eval(), actor.to(device).eval()


class PlayerDV3:
    """Stateful env-interaction wrapper: per-env recurrent, stochastic and
    action state as device tensors; resets are mask-based blends."""

    def __init__(self, world_model: WorldModel, actor: Actor, actions_dim: Sequence[int], num_envs: int):
        self.world_model = world_model
        self.actor = actor
        self.actions_dim = tuple(actions_dim)
        self.num_envs = num_envs
        self.state: Optional[Dict[str, torch.Tensor]] = None

    def _init_state(self, n: int) -> Dict[str, torch.Tensor]:
        h0, z0 = self.world_model.initial_states((n,))
        return {"recurrent": h0, "stochastic": z0, "actions": torch.zeros((n, sum(self.actions_dim)), device=h0.device)}

    @torch.no_grad()
    def init_states(self, reset_mask: Optional[torch.Tensor] = None) -> None:
        """Full or masked state reset; ``reset_mask`` is ``[num_envs, 1]``
        float (1 = reset that env)."""
        init = self._init_state(self.num_envs)
        if self.state is None or reset_mask is None:
            self.state = init
        else:
            self.state = {k: reset_mask * init[k] + (1 - reset_mask) * self.state[k] for k in init}

    @torch.no_grad()
    def get_actions(
        self,
        obs: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        noise: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """One policy step.  ``noise`` may hold ``"representation"`` (Gumbel
        ``[B, stoch, discrete]``) and ``"actor"`` (one tensor per head)."""
        noise = noise or {}
        wm = self.world_model
        embedded = wm.encode(obs)
        recurrent = wm.recurrent_step(self.state["stochastic"], self.state["actions"], self.state["recurrent"])
        _, stochastic = wm.representation(
            None if wm.decoupled_rssm else recurrent, embedded, generator, noise.get("representation")
        )
        actions = self.actor.act(torch.cat([stochastic, recurrent], dim=-1), generator, greedy, noise.get("actor"))
        self.state = {"recurrent": recurrent, "stochastic": stochastic, "actions": actions}
        return actions
