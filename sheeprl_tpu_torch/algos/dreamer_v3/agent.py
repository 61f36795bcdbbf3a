"""DreamerV3 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v3/agent.py``).

Ported: the dense stack, the CNN and MLP encoders and decoders, the recurrent
model, the RSSM (initial states, representation, transition, ``dynamic`` and
``imagination``), the reward and continue heads, the world model's methods,
the actor's ``act`` and ``log_prob_entropy`` for discrete heads and the
continuous ``scaled_normal``, ``normal``, ``tanh_normal`` and
``trunc_normal`` heads, the critic, ``build_agent`` and ``PlayerDV3``.
``MinedojoActor`` is still to port (ROADMAP.md, Queue 1).

Layouts follow the JAX package at every public function: observations are
CHW, stochastic states flat ``[..., stochastic * discrete]``.  The conv
stack runs NCHW and permutes to NHWC before its flatten, so the embedding
has the JAX package's (h, w, c) order and converted weights line up.

The decoder's transposed convolutions take the flax ``ConvTranspose``
weights through the converter (``interop/flax_params.py``): flax keeps the
kernel ``[kh, kw, in, out]`` and does not flip it, torch's
``ConvTranspose2d`` is the gradient of a convolution, so the converter flips
the kernel; flax's ``"SAME"`` at kernel 4, stride 2 pads the dilated input by
(2, 2), which is ``padding=1`` here.

Sampling takes optional pre-drawn noise (``compute_stochastic_state``'s and
the discrete heads' Gumbel noise, the continuous head's standard normal or,
for ``trunc_normal``, uniform draw):
``jax.random.categorical(k, l)`` is ``argmax(l + gumbel(k, l.shape))``, so a
test that feeds both packages the same draws compares them exactly.
Without noise, draws come from the ``torch.Generator`` passed in.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import math
from math import prod
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from sheeprl_tpu_torch.models.blocks import LayerNormChannelLast, LayerNormGRUCell, get_activation
from sheeprl_tpu_torch.ops.distributions import TruncatedNormal
from sheeprl_tpu_torch.ops.numerics import safeatanh, symlog
from sheeprl_tpu_torch.parallel.dp import draw
from sheeprl_tpu_torch.parallel.precision import call_cast


def gumbel_like(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise shaped like ``x`` (rows first), from
    ``generator`` (or a shard's block of a ``parallel/dp.py::GlobalStream``)."""
    u = draw(torch.rand, x.shape, generator, dtype=x.dtype, device=x.device)
    tiny = torch.finfo(x.dtype).tiny
    return -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))


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


class CNNDecoderDV3(nn.Module):
    """Inverse of the encoder: a dense projection to a
    ``start x start`` map, then stride-2 transposed convolutions back to the
    image size.  Returns the channel-concat reconstruction, CHW."""

    def __init__(self, latent_size: int, total_channels: int, channels_multiplier: int, image_size: Tuple[int, int],
                 stages: int = 4, eps: float = 1e-3, act: str = "silu", layer_norm: bool = True):
        super().__init__()
        self.act = get_activation(act)
        self.start = image_size[0] // (2**stages)
        self.top_channels = (2 ** (stages - 1)) * channels_multiplier
        self.dense = nn.Linear(latent_size, self.start * self.start * self.top_channels)
        channels = [self.top_channels] + [(2 ** (stages - i - 2)) * channels_multiplier for i in range(stages - 1)]
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(channels[i], channels[i + 1], 4, stride=2, padding=1, bias=not layer_norm)
            for i in range(stages - 1)
        )
        self.norms = (
            nn.ModuleList(LayerNormChannelLast(channels[i + 1], eps=eps) for i in range(stages - 1))
            if layer_norm
            else None
        )
        self.out = nn.ConvTranspose2d(channels[-1], total_channels, 4, stride=2, padding=1)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        lead = latent.shape[:-1]
        # the dense output is laid out (h, w, c), as the JAX package reshapes it
        x = self.dense(latent).reshape(-1, self.start, self.start, self.top_channels).permute(0, 3, 1, 2)
        for i, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
        x = self.out(x)
        return x.reshape(tuple(lead) + tuple(x.shape[1:]))


class MLPDecoderDV3(nn.Module):
    """Dense decoder with one linear head per vector key."""

    def __init__(self, latent_size: int, keys: Sequence[str], output_dims: Sequence[int], dense_units: int,
                 mlp_layers: int, eps: float = 1e-3, act: str = "silu", layer_norm: bool = True):
        super().__init__()
        self.keys = tuple(keys)
        self.stack = DenseStack(latent_size, dense_units, mlp_layers, eps, act, layer_norm)
        self.heads = nn.ModuleList(nn.Linear(self.stack.out_features, int(d)) for d in output_dims)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stack(latent)
        return {k: head(x) for k, head in zip(self.keys, self.heads)}


class PredictionHead(nn.Module):
    """Dense stack + linear head: the reward (zero-initialized head) and
    continue (uniform head) models, and the critic's body."""

    def __init__(self, in_features: int, dense_units: int, mlp_layers: int, out_dim: int, eps: float = 1e-3,
                 act: str = "silu", layer_norm: bool = True):
        super().__init__()
        self.stack = DenseStack(in_features, dense_units, mlp_layers, eps, act, layer_norm)
        self.head = nn.Linear(self.stack.out_features, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.stack(x))


#: the two-hot critic: a dense stack and a zero-initialized head of ``bins``
Critic = PredictionHead


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
        # in the logits' dtype, as jax.random.categorical draws its noise
        idx = torch.argmax(logits + noise.reshape(logits.shape).to(logits.dtype), dim=-1)
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

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, is_first, generator=None, noise=None):
        """One step of dynamic learning; ``is_first`` (``[B, 1]``) resets to
        the learned initial state.  ``noise`` is ``(prior, posterior)``
        Gumbel noise, each ``[B, stoch, discrete]``.  Returns
        ``(recurrent, posterior, prior, posterior_logits, prior_logits)``."""
        prior_noise, post_noise = noise if noise is not None else (None, None)
        action = (1 - is_first) * action
        initial_recurrent, initial_posterior = self.get_initial_states(recurrent_state.shape[:-1])
        recurrent_state = (1 - is_first) * recurrent_state + is_first * initial_recurrent
        posterior = (1 - is_first) * posterior + is_first * initial_posterior
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        prior_logits, prior = self._transition(recurrent_state, generator, noise=prior_noise)
        posterior_logits, posterior = self._representation(recurrent_state, embedded_obs, generator, post_noise)
        return recurrent_state, posterior, prior, posterior_logits, prior_logits

    def imagination(self, prior, recurrent_state, actions, generator=None, noise=None):
        """One step of latent imagination: ``(imagined_prior, recurrent)``."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], dim=-1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, generator, noise=noise)
        return imagined_prior, recurrent_state


class WorldModel(nn.Module):
    """Encoders, RSSM, decoders, reward and continue heads: one module, one
    optimizer, as the JAX package keeps them in one params tree."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_input_channels: int, mlp_input_dim: int,
                 image_size: Tuple[int, int], channels_multiplier: int, cnn_stages: int, encoder_dense_units: int,
                 encoder_mlp_layers: int, recurrent_state_size: int, stochastic_size: int, discrete_size: int,
                 actions_dim: int, rssm_dense_units: int, rssm_hidden_size: int, cnn_decoder_keys: Sequence[str] = (),
                 cnn_decoder_channels: Sequence[int] = (), mlp_decoder_keys: Sequence[str] = (),
                 mlp_output_dims: Sequence[int] = (), decoder_dense_units: int = 512, decoder_mlp_layers: int = 2,
                 reward_dense_units: int = 512, reward_mlp_layers: int = 2, reward_bins: int = 255,
                 continue_dense_units: int = 512, continue_mlp_layers: int = 2, unimix: float = 0.01,
                 eps: float = 1e-3, learnable_initial_recurrent_state: bool = True, decoupled_rssm: bool = False,
                 dense_act: str = "silu", cnn_act: str = "silu", layer_norm: bool = True,
                 gru_layer_norm: bool = True, symlog_inputs: bool = True, hafner_heads: bool = True):
        super().__init__()
        self.decoupled_rssm = decoupled_rssm
        # DreamerV3's uniform stochastic and continue heads and zero reward
        # head (``init_weights``); off, they take the dense default (DV1, DV2)
        self.hafner_heads = hafner_heads
        latent_size = stochastic_size * discrete_size + recurrent_state_size
        self.cnn_decoder_keys = tuple(cnn_decoder_keys)
        self.cnn_decoder_channels = tuple(int(c) for c in cnn_decoder_channels)
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
        self.cnn_decoder = (
            CNNDecoderDV3(latent_size, sum(self.cnn_decoder_channels), channels_multiplier, image_size, cnn_stages,
                          eps, cnn_act, layer_norm)
            if cnn_decoder_keys
            else None
        )
        self.mlp_decoder = (
            MLPDecoderDV3(latent_size, mlp_decoder_keys, mlp_output_dims, decoder_dense_units, decoder_mlp_layers, eps,
                          dense_act, layer_norm)
            if mlp_decoder_keys
            else None
        )
        self.reward_model = PredictionHead(latent_size, reward_dense_units, reward_mlp_layers, reward_bins, eps,
                                           dense_act, layer_norm)
        self.continue_model = PredictionHead(latent_size, continue_dense_units, continue_mlp_layers, 1, eps,
                                             dense_act, layer_norm)

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

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_decoder is not None:
            recon = self.cnn_decoder(latent)
            start = 0
            for k, c in zip(self.cnn_decoder_keys, self.cnn_decoder_channels):
                out[k] = recon[..., start : start + c, :, :]
                start += c
        if self.mlp_decoder is not None:
            out.update(self.mlp_decoder(latent))
        return out

    def reward_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent)

    def continue_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent)

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, is_first, generator=None, noise=None):
        return self.rssm.dynamic(posterior, recurrent_state, action, embedded_obs, is_first, generator, noise)

    def imagination(self, prior, recurrent_state, actions, generator=None, noise=None):
        return self.rssm.imagination(prior, recurrent_state, actions, generator, noise)


class Actor(nn.Module):
    """DV3 actor: dense backbone + one head per discrete sub-action (unimix +
    straight-through) or one (mean, std) head for a continuous distribution:
    ``scaled_normal`` (DreamerV3's), ``normal``, ``tanh_normal`` (DreamerV1's)
    or ``trunc_normal`` (DreamerV2's).  ``auto`` is ``discrete`` for discrete
    actions and ``default_continuous_dist`` for continuous ones, which each
    family sets for its own."""

    def __init__(self, latent_state_size: int, actions_dim: Sequence[int], is_continuous: bool,
                 distribution: str = "auto", init_std: float = 2.0, min_std: float = 0.1, max_std: float = 1.0,
                 dense_units: int = 1024, mlp_layers: int = 5, unimix: float = 0.01, action_clip: float = 1.0,
                 eps: float = 1e-3, dense_act: str = "silu", layer_norm: bool = True,
                 default_continuous_dist: str = "scaled_normal"):
        super().__init__()
        dist = distribution.lower()
        if dist not in ("auto", "normal", "tanh_normal", "discrete", "scaled_normal", "trunc_normal"):
            raise ValueError(f"Invalid actor distribution: {dist}")
        if dist == "auto":
            dist = default_continuous_dist if is_continuous else "discrete"
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

    def _continuous_dist_params(self, pre: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mean and std of the continuous head's distribution."""
        mean, std = torch.chunk(pre, 2, dim=-1)
        if self.dist == "tanh_normal":
            return 5 * torch.tanh(mean / 5), F.softplus(std + self.init_std) + self.min_std
        if self.dist == "trunc_normal":
            return torch.tanh(mean), 2 * torch.sigmoid((std + self.init_std) / 2) + self.min_std
        if self.dist == "scaled_normal":
            std = (self.max_std - self.min_std) * torch.sigmoid(std + self.init_std) + self.min_std
            return torch.tanh(mean), std
        return mean, std  # normal

    def log_prob_entropy(self, state: torch.Tensor, actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Log-prob of the given (concatenated) actions and the policy
        entropy, both ``[..., 1]``.  A tanh-normal has no closed-form
        entropy: it is the negated log-prob, as in the JAX package."""
        pre_dist = self(state)
        if self.is_continuous:
            mean, std = self._continuous_dist_params(pre_dist[0])
            if self.dist == "trunc_normal":
                dist = TruncatedNormal(mean, std, -1.0, 1.0, event_dims=1)
                return dist.log_prob(actions)[..., None], dist.entropy()[..., None]
            x = safeatanh(actions, 1e-6) if self.dist == "tanh_normal" else actions
            lp = -((x - mean) ** 2) / (2 * std**2) - torch.log(std) - 0.5 * math.log(2 * math.pi)
            if self.dist == "tanh_normal":
                log_prob = (lp - torch.log1p(-(actions**2) + 1e-6)).sum(dim=-1, keepdim=True)
                return log_prob, -log_prob
            ent = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std)
            return lp.sum(dim=-1, keepdim=True), ent.sum(dim=-1, keepdim=True)
        log_prob, entropy = 0.0, 0.0
        start = 0
        for logits in pre_dist:
            d = logits.shape[-1]
            logits = torch.log_softmax(_unimix(logits, d, self.unimix), dim=-1)
            log_prob = log_prob + (actions[..., start : start + d] * logits).sum(dim=-1, keepdim=True)
            entropy = entropy - (logits.exp() * logits).sum(dim=-1, keepdim=True)
            start += d
        return log_prob, entropy

    def act(
        self,
        state: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        noise: Optional[Sequence[torch.Tensor]] = None,
        mask: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Sample (or take the mode of) the actions, concatenated over heads.
        ``noise`` holds one tensor per head: Gumbel noise shaped like each
        discrete head's logits, or for the continuous head a standard-normal
        draw (a uniform draw in ``[1e-6, 1 - 1e-6]`` for ``trunc_normal``).
        Greedy takes the mean (its tanh for ``tanh_normal``).  ``mask`` (the
        ``mask_*`` observations, or None) is ignored here;
        :class:`MinedojoActor` masks its heads with it."""
        pre_dist = self(state)
        if self.is_continuous:
            mean, std = self._continuous_dist_params(pre_dist[0])
            if greedy:
                actions = mean
            elif self.dist == "trunc_normal":
                u = noise[0] if noise is not None else 1e-6 + (1 - 2e-6) * draw(
                    torch.rand, mean.shape, generator, dtype=mean.dtype, device=mean.device)
                actions = TruncatedNormal(mean, std, -1.0, 1.0).rsample(u)
            else:
                eps = noise[0] if noise is not None else draw(
                    torch.randn, mean.shape, generator, dtype=mean.dtype, device=mean.device)
                actions = mean + std * eps.to(mean.dtype)
            if self.dist == "tanh_normal":
                actions = torch.tanh(actions)
            if self.action_clip > 0.0:
                clip = torch.full_like(actions, self.action_clip)
                actions = actions * (clip / torch.maximum(clip, torch.abs(actions))).detach()
            return actions
        outs = []
        functional_action = None
        for i, logits in enumerate(pre_dist):
            logits = _unimix(logits, logits.shape[-1], self.unimix)
            logits = self._masked_logits_for_head(i, logits, functional_action, mask)
            if greedy:
                one_hot = F.one_hot(torch.argmax(logits, dim=-1), logits.shape[-1]).to(logits.dtype)
            else:
                gumbel = noise[i] if noise is not None else gumbel_like(logits, generator)
                hard = F.one_hot(torch.argmax(logits + gumbel.to(logits.dtype), dim=-1), logits.shape[-1]).to(
                    logits.dtype)
                probs = torch.softmax(logits, dim=-1)
                one_hot = hard + probs - probs.detach()
            outs.append(one_hot)
            if functional_action is None:
                functional_action = torch.argmax(one_hot, dim=-1)
        return torch.cat(outs, dim=-1)

    def _masked_logits_for_head(self, i: int, logits: torch.Tensor, functional_action: Optional[torch.Tensor],
                                mask: Optional[Mapping[str, torch.Tensor]]) -> torch.Tensor:
        """The logits of head ``i`` after the unimix transform, as sampled
        (the base actor's: unchanged)."""
        return logits


class MinedojoActor(Actor):
    """The actor for MineDojo's MultiDiscrete ``[action type (19), craft
    argument, equip/place/destroy argument]`` actions, masked hierarchically
    by the env's per-step ``mask_*`` observations when ``act`` gets them:
    head 0 by ``mask_action_type``; head 1 by ``mask_craft_smelt`` where the
    action type taken is craft (15); head 2 by ``mask_equip_place`` where it
    is equip or place (16, 17) and by ``mask_destroy`` where it is destroy
    (18).  A masked category's logit is ``-inf`` after the unimix transform,
    so the others renormalize through the softmax.  The selections are
    tensor ``where``s on the action taken, not loops over the batch.  The
    log-probs and entropies of training are the base actor's."""

    CRAFT_ACTION = 15
    EQUIP_ACTION = 16
    PLACE_ACTION = 17
    DESTROY_ACTION = 18

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        if self.is_continuous:
            raise ValueError("MinedojoActor only supports discrete (MultiDiscrete) action spaces")

    def _masked_logits_for_head(self, i: int, logits: torch.Tensor, functional_action: Optional[torch.Tensor],
                                mask: Optional[Mapping[str, torch.Tensor]]) -> torch.Tensor:
        if mask is None or i > 2:
            return logits

        def allowed_by(key: str) -> torch.Tensor:
            return mask[key].to(torch.bool).expand_as(logits)

        if i == 0:
            allowed = allowed_by("mask_action_type")
        elif i == 1:
            craft = (functional_action == self.CRAFT_ACTION)[..., None]
            allowed = torch.where(craft, allowed_by("mask_craft_smelt"), True)
        else:
            equip_place = ((functional_action == self.EQUIP_ACTION)
                           | (functional_action == self.PLACE_ACTION))[..., None]
            destroy = (functional_action == self.DESTROY_ACTION)[..., None]
            allowed = torch.where(equip_place, allowed_by("mask_equip_place"),
                                  torch.where(destroy, allowed_by("mask_destroy"), True))
        return logits.masked_fill(~allowed, float("-inf"))


def resolve_actor_cls(actor_cfg) -> type:
    """The actor class ``algo.actor.cls`` names (:class:`Actor` when it is
    unset), for the DreamerV1/V2/V3 actors and so for Plan2Explore's and
    JEPA's; a name in the JAX package (an archived run's config) names the
    port's counterpart.  A name that is not an :class:`Actor` subclass
    raises."""
    name = actor_cfg.get("cls")
    if not name:
        return Actor
    name = str(name)
    if name.startswith("sheeprl_tpu."):
        name = "sheeprl_tpu_torch." + name[len("sheeprl_tpu."):]
    module_name, _, attr = name.rpartition(".")
    actor_cls = getattr(importlib.import_module(module_name), attr)
    if not (isinstance(actor_cls, type) and issubclass(actor_cls, Actor)):
        raise ValueError(f"algo.actor.cls must name an Actor subclass, got {actor_cfg.get('cls')!r}")
    return actor_cls


def _trunc_normal_fan_avg_(weight: torch.Tensor, fan_in: int, fan_out: int, generator: torch.Generator) -> None:
    # variance_scaling(1.0, "fan_avg", "truncated_normal"): the 0.8796 rescales
    # a [-2, 2]-truncated standard normal back to unit variance
    std = math.sqrt(1.0 / ((fan_in + fan_out) / 2.0)) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _uniform_fan_avg_(weight: torch.Tensor, fan_in: int, fan_out: int, generator: torch.Generator) -> None:
    limit = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
    nn.init.uniform_(weight, -limit, limit, generator=generator)


#: the modules DreamerV3's optimizers train, in the order of its step
TRAINED = ("world_model", "actor", "critic")


class Agent(NamedTuple):
    """The four module trees of a DreamerV3 agent, as a checkpoint holds
    them.  The training loop reaches which optimizers the agent has, what
    each trains and what a checkpoint holds through the methods, which a
    family with more modules (DreamerV3-JEPA, Plan2Explore) defines for its
    own."""

    world_model: WorldModel
    actor: Actor
    critic: Critic
    target_critic: Critic

    def optimizer_configs(self, cfg) -> Dict[str, Any]:
        """The optimizers the agent trains, by name in the order of the
        step, each with its config section (its ``optimizer`` and
        ``clip_gradients``)."""
        return {name: cfg.algo[name] for name in TRAINED}

    def initial_moments(self, device: torch.device | str = "cpu") -> Dict[str, Any]:
        """The Moments state the step starts from (a family with more
        critics keeps a tree of them)."""
        from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state

        return init_moments_state(device)

    def parameters_of(self, name: str) -> List[nn.Parameter]:
        """What the optimizer ``name`` (world_model, actor or critic) trains."""
        return list(getattr(self, name).parameters())

    def optimizer_spec(self, name: str) -> Dict[str, Any]:
        """:meth:`parameters_of` ``name`` in the layout of the flax tree its
        optax state follows (``interop/flax_params.py``)."""
        from sheeprl_tpu_torch.interop.flax_params import param_spec

        return param_spec(*self)[name]

    def trees(self) -> Dict[str, Any]:
        """The weights as a checkpoint holds them: the JAX package's four
        flax trees (numpy)."""
        from sheeprl_tpu_torch.interop.flax_params import to_flax

        return to_flax(*self)


class _SkipDefaultInit(TorchFunctionMode):
    """Skips ``nn.init.kaiming_uniform_`` and ``nn.init.uniform_``, the
    default initialisation of ``nn.Linear``, ``nn.Conv2d`` and
    ``nn.ConvTranspose2d``, and keeps every tensor it left as constructed."""

    def __init__(self):
        super().__init__()
        self.skipped: List[torch.Tensor] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (nn.init.kaiming_uniform_, nn.init.uniform_):
            tensor = args[0] if args else kwargs["tensor"]
            self.skipped.append(tensor)
            return tensor
        return func(*args, **kwargs)


@contextlib.contextmanager
def skip_default_init():
    """Construct modules that :func:`init_weights` then initializes, without
    torch's default initialisation of their dense and conv layers (at XL
    widths it cost as much as Hafner's).  Yields the list of tensors left
    as constructed, for ``init_weights(..., constructed=...)`` to check
    that it writes every one in full.  The default initialisation drew
    from torch's global generator, which no other draw of the DreamerV3
    family reads: the weights are bit for bit those of a default-initialised
    construction."""
    mode = _SkipDefaultInit()
    with mode:
        yield mode.skipped


@torch.no_grad()
def init_weights(world_model: Optional[WorldModel], actor: Optional[Actor], critic: Optional[Critic],
                 generator: torch.Generator, hafner_heads: bool = True,
                 constructed: Optional[Sequence[torch.Tensor]] = None) -> None:
    """Hafner initialization from a seeded generator: truncated-normal
    fan-avg for every dense and conv kernel; uniform fan-avg for the actor
    and decoder output heads and, with ``hafner_heads`` (DreamerV3's), the
    stochastic-state and continue heads; with it too, zero reward and critic
    heads; zero biases, unit LayerNorm scales.  Without ``hafner_heads``
    (DreamerV1's and V2's) those heads are truncated-normal like the rest.
    The modules draw in the order world model, actor, critic; one left out
    (None) draws nothing, so leaving out the critic changes no other
    module's weights."""
    uniform = [*actor.heads] if actor is not None else []
    zero = {id(critic.head)} if critic is not None and hafner_heads else set()
    if world_model is not None:
        if hafner_heads:
            uniform += [world_model.rssm.representation_model.head, world_model.rssm.transition_model.head,
                        world_model.continue_model.head]
            zero.add(id(world_model.reward_model.head))
        if world_model.cnn_decoder is not None:
            uniform.append(world_model.cnn_decoder.out)
        if world_model.mlp_decoder is not None:
            uniform.extend(world_model.mlp_decoder.heads)
    uniform_ids = {id(m) for m in uniform}
    modules = [m for part in (world_model, actor, critic) if part is not None for m in part.modules()]
    if constructed is not None:
        written = {id(t) for m in modules if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))
                   for t in (m.weight, m.bias) if t is not None}
        unwritten = [tuple(t.shape) for t in constructed if id(t) not in written]
        if unwritten:
            raise RuntimeError(f"skip_default_init left tensors that init_weights does not write: {unwritten}")
    for module in modules:
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = module.weight
            # fan-avg is symmetric in (in, out), so torch's two conv layouts
            # need no distinction
            receptive = prod(w.shape[2:]) if w.dim() > 2 else 1
            fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
            if id(module) in zero:
                w.zero_()
            elif id(module) in uniform_ids:
                _uniform_fan_avg_(w, fan_in, fan_out, generator)
            else:
                _trunc_normal_fan_avg_(w, fan_in, fan_out, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


def _world_model_and_actor(actions_dim: Sequence[int], is_continuous: bool, cfg,
                           obs_space) -> Tuple[WorldModel, Actor]:
    """The configured world model and actor, uninitialized, on the CPU."""
    wm_cfg = cfg.algo.world_model
    eps = _eps(cfg)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    cnn_decoder_keys = list(cfg.algo.cnn_keys.decoder)
    mlp_decoder_keys = list(cfg.algo.mlp_keys.decoder)
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
        cnn_decoder_keys=cnn_decoder_keys,
        cnn_decoder_channels=[int(prod(obs_space[k].shape[:-2])) for k in cnn_decoder_keys],
        mlp_decoder_keys=mlp_decoder_keys,
        mlp_output_dims=[int(prod(obs_space[k].shape)) for k in mlp_decoder_keys],
        decoder_dense_units=wm_cfg.observation_model.dense_units,
        decoder_mlp_layers=wm_cfg.observation_model.mlp_layers,
        reward_dense_units=wm_cfg.reward_model.dense_units,
        reward_mlp_layers=wm_cfg.reward_model.mlp_layers,
        reward_bins=wm_cfg.reward_model.bins,
        continue_dense_units=wm_cfg.discount_model.dense_units,
        continue_mlp_layers=wm_cfg.discount_model.mlp_layers,
        unimix=cfg.algo.unimix,
        eps=eps,
        learnable_initial_recurrent_state=wm_cfg.learnable_initial_recurrent_state,
        decoupled_rssm=wm_cfg.decoupled_rssm,
    )
    return world_model, make_actor(actions_dim, is_continuous, cfg)


def _eps(cfg) -> float:
    return float(cfg.algo.mlp_layer_norm.kw.get("eps", 1e-3)) if cfg.algo.get("mlp_layer_norm") else 1e-3


def _latent_state_size(cfg) -> int:
    wm_cfg = cfg.algo.world_model
    return wm_cfg.stochastic_size * wm_cfg.discrete_size + wm_cfg.recurrent_model.recurrent_state_size


def make_actor(actions_dim: Sequence[int], is_continuous: bool, cfg) -> Actor:
    """The configured actor, uninitialized, on the CPU."""
    actor_cfg = cfg.algo.actor
    return resolve_actor_cls(actor_cfg)(
        latent_state_size=_latent_state_size(cfg),
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
        eps=_eps(cfg),
    )


def make_critic(cfg) -> Critic:
    """The configured critic, uninitialized, on the CPU."""
    critic_cfg = cfg.algo.critic
    return Critic(_latent_state_size(cfg), critic_cfg.dense_units, critic_cfg.mlp_layers, critic_cfg.bins, _eps(cfg))


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    agent_state: Optional[Mapping[str, Any]] = None,
    device: torch.device | str = "cpu",
) -> Agent:
    """Build the world model, actor, critic and target critic on ``device``.
    Weights come from ``agent_state`` when given (a checkpoint's
    ``{"world_model": {"params": ...}, "actor": ..., "critic": ...,
    "target_critic": ...}`` in the JAX package's layout, all four trees),
    else from ``init_weights`` seeded with ``cfg.seed``, the target critic a
    copy of the critic.  The target critic never takes a gradient."""
    with skip_default_init() as constructed:
        world_model, actor = _world_model_and_actor(actions_dim, is_continuous, cfg, obs_space)
        critic = make_critic(cfg)
    init_weights(world_model, actor, critic, torch.Generator().manual_seed(int(cfg.seed or 0)),
                 constructed=constructed)
    target_critic = copy.deepcopy(critic)
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import from_flax

        from_flax(agent_state, world_model, actor, critic, target_critic)
    target_critic.requires_grad_(False)
    return Agent(world_model.to(device), actor.to(device), critic.to(device), target_critic.to(device))


def build_policy_modules(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    agent_state: Optional[Mapping[str, Any]] = None,
    device: torch.device | str = "cpu",
) -> Tuple[WorldModel, Actor]:
    """The two modules a policy acts with, for serving: the world model
    without its decoders and reward and continue heads, and the actor, on
    ``device``; no critic is built.  Weights come from ``agent_state``
    through the converter's policy spec, which reads the world model's
    encoders and RSSM and the actor, strictly, and leaves the critics,
    decoders and heads unread whether the checkpoint holds them or not (the
    JAX package's ``build_policy`` serves a checkpoint without the critics
    too).  Without ``agent_state`` the weights are ``build_agent``'s for the
    same seed."""
    with skip_default_init() as constructed:
        world_model, actor = _world_model_and_actor(actions_dim, is_continuous, cfg, obs_space)
    init_weights(world_model, actor, None, torch.Generator().manual_seed(int(cfg.seed or 0)),
                 constructed=constructed)
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import from_flax_policy

        from_flax_policy(agent_state, world_model, actor)
    world_model.cnn_decoder = world_model.mlp_decoder = None
    world_model.reward_model = world_model.continue_model = None
    return world_model.to(device), actor.to(device)


class PlayerDV3:
    """Stateful env-interaction wrapper: per-env recurrent, stochastic and
    action state as device tensors; resets are mask-based blends.  The
    player computes in fp32 whatever the parameters' dtype: under
    ``bf16-true`` its calls see fp32 casts of the bf16 weights, as flax
    promotes bf16 weights and fp32 observations to fp32 in the JAX player."""

    def __init__(self, world_model: WorldModel, actor: Actor, actions_dim: Sequence[int], num_envs: int):
        self.world_model = world_model
        self.actor = actor
        self.actions_dim = tuple(actions_dim)
        self.num_envs = num_envs
        self.state: Optional[Dict[str, torch.Tensor]] = None

    def _init_state(self, n: int) -> Dict[str, torch.Tensor]:
        h0, z0 = self.world_model.initial_states((n,))
        return {"recurrent": h0, "stochastic": z0, "actions": torch.zeros((n, sum(self.actions_dim)), device=h0.device)}

    def _fp32(self, fn):
        return call_cast((self.world_model, self.actor), torch.float32, fn)

    @torch.no_grad()
    def init_states(self, reset_mask: Optional[torch.Tensor] = None) -> None:
        """Full or masked state reset; ``reset_mask`` is ``[num_envs, 1]``
        float (1 = reset that env)."""
        init = self._fp32(lambda: self._init_state(self.num_envs))
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
        mask: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """One policy step.  ``noise`` may hold ``"representation"`` (Gumbel
        ``[B, stoch, discrete]``) and ``"actor"`` (one tensor per head);
        ``mask`` (the ``mask_*`` observations, or None) goes to the actor
        (:class:`MinedojoActor` masks its heads with it)."""
        return self._fp32(lambda: self._step(obs, generator, greedy, noise or {}, mask))

    def _step(self, obs, generator, greedy, noise, mask=None) -> torch.Tensor:
        wm = self.world_model
        embedded = wm.encode(obs)
        recurrent = wm.recurrent_step(self.state["stochastic"], self.state["actions"], self.state["recurrent"])
        _, stochastic = wm.representation(
            None if wm.decoupled_rssm else recurrent, embedded, generator, noise.get("representation")
        )
        actions = self.actor.act(torch.cat([stochastic, recurrent], dim=-1), generator, greedy, noise.get("actor"),
                                 mask)
        self.state = {"recurrent": recurrent, "stochastic": stochastic, "actions": actions}
        return actions
