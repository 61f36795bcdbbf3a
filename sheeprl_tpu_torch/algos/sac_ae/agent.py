"""The SAC-AE agent (counterpart of ``sheeprl_tpu/algos/sac_ae/agent.py``;
SAC+AE, https://arxiv.org/abs/1910.01741): pixel SAC with a convolutional
autoencoder.

- :class:`SACAEEncoder`: four VALID 3x3 convolutions with strides 2/1/1/1
  (64 -> 31 -> 29 -> 27 -> 25) and ReLU, a dense layer over the map, a
  LayerNorm (eps 1e-6) and tanh; beside it a ReLU stack, a dense layer, a
  LayerNorm and tanh over the vector keys.  The JAX encoder flattens the
  NHWC map in (H, W, C) order; the port's flattens NCHW and the weight
  converter permutes the dense layer's rows (``dense_nhwc``).  A frame
  stack's frames are folded into the channels, as upstream sheeprl does
  (ROADMAP.md Queue 3: the JAX encoder runs them as a batch axis).
- :class:`SACAEDecoder`: a dense layer to the 25x25 map (its output rows
  permuted by the converter, ``dense_to_hwc``), three stride-1 3x3
  transposed convolutions with ReLU and a 4x4 stride-2 one to 64x64; a
  ReLU stack and a dense layer for the vector keys.
- SAC's actor (``LOG_STD_MIN = -10``) and stacked critics over the
  features.

Every layer computes in the promotion of its input's and its parameters'
dtypes, as flax's layers with ``dtype=None`` do.
"""

from __future__ import annotations

from math import prod
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent, SACCritics, dense
from sheeprl_tpu_torch.models.blocks import MLP, lecun_normal_

LOG_STD_MIN = -10.0
LAYER_NORM_EPS = 1e-6


def _promoted(x: torch.Tensor, layer: nn.Module) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    return x.to(dt), layer.weight.to(dt), None if layer.bias is None else layer.bias.to(dt)


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(*_promoted(x, layer), stride=layer.stride)


def conv_transpose(x: torch.Tensor, layer: nn.ConvTranspose2d) -> torch.Tensor:
    return F.conv_transpose2d(*_promoted(x, layer), stride=layer.stride)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    x, w, b = _promoted(x, layer)
    return F.layer_norm(x, layer.normalized_shape, w, b, layer.eps)


def mlp(x: torch.Tensor, stack: MLP) -> torch.Tensor:
    """A ReLU ``MLP`` without norms or output layer, promoted per layer."""
    for layer in stack.dense:
        x = F.relu(dense(x, layer))
    return x


def conv_hw(screen_size: int) -> int:
    """The side of the encoder's last map: 64 -> 31 -> 29 -> 27 -> 25."""
    return (int(screen_size) - 3) // 2 + 1 - 6


class SACAEEncoder(nn.Module):
    """``forward(obs, detach_encoder_features=False) -> features``:
    ``features_dim`` per branch, pixels first.  ``obs`` holds the pixel keys
    as ``[..., C, H, W]`` floats in ``[0, 1]`` and the vector keys as
    ``[..., D]``."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], in_channels: int, screen_size: int,
                 mlp_dim: int, features_dim: int, channels_multiplier: int, dense_units: int, mlp_layers: int):
        super().__init__()
        self.cnn_keys, self.mlp_keys = list(cnn_keys), list(mlp_keys)
        self.features_dim = int(features_dim)
        self.convs = self.mlp = None
        if self.cnn_keys:
            ch, hw = 32 * int(channels_multiplier), conv_hw(screen_size)
            self.convs = nn.ModuleList([nn.Conv2d(int(in_channels), ch, 3, stride=2)] +
                                       [nn.Conv2d(ch, ch, 3, stride=1) for _ in range(3)])
            self.cnn_fc = nn.Linear(hw * hw * ch, self.features_dim)
            self.cnn_fc.flatten_hwc = (hw, hw, ch)
            self.cnn_norm = nn.LayerNorm(self.features_dim, eps=LAYER_NORM_EPS)
        if self.mlp_keys:
            self.mlp = MLP(mlp_dim, [int(dense_units)] * int(mlp_layers), None, "relu")
            self.mlp_fc = nn.Linear(self.mlp.output_dim, self.features_dim)
            self.mlp_norm = nn.LayerNorm(self.features_dim, eps=LAYER_NORM_EPS)
        self.output_dim = self.features_dim * (int(bool(self.cnn_keys)) + int(bool(self.mlp_keys)))

    def forward(self, obs: Dict[str, torch.Tensor], detach_encoder_features: bool = False) -> torch.Tensor:
        feats = []
        if self.convs is not None:
            x = torch.cat([obs[k] for k in self.cnn_keys], dim=-3)
            lead = x.shape[:-3]
            x = x.reshape(-1, *x.shape[-3:])
            for layer in self.convs:
                x = F.relu(conv(x, layer))
            x = x.reshape(*lead, -1)
            if detach_encoder_features:
                x = x.detach()
            feats.append(torch.tanh(layer_norm(dense(x, self.cnn_fc), self.cnn_norm)))
        if self.mlp is not None:
            v = mlp(torch.cat([obs[k] for k in self.mlp_keys], dim=-1), self.mlp)
            if detach_encoder_features:
                v = v.detach()
            feats.append(torch.tanh(layer_norm(dense(v, self.mlp_fc), self.mlp_norm)))
        if len(feats) == 1:
            return feats[0]
        dt = torch.promote_types(feats[0].dtype, feats[1].dtype)
        return torch.cat([f.to(dt) for f in feats], dim=-1)


class SACAEDecoder(nn.Module):
    """``forward(features) -> {key: reconstruction}``: the pixel keys as
    ``[..., C, 64, 64]``, the vector keys as ``[..., D]``."""

    def __init__(self, cnn_keys: Sequence[str], cnn_channels: Sequence[int], mlp_keys: Sequence[str],
                 mlp_dims: Sequence[int], in_dim: int, channels_multiplier: int, screen_size: int, dense_units: int,
                 mlp_layers: int):
        super().__init__()
        self.cnn_keys, self.cnn_channels = list(cnn_keys), [int(c) for c in cnn_channels]
        self.mlp_keys, self.mlp_dims = list(mlp_keys), [int(d) for d in mlp_dims]
        self.deconvs = self.mlp = None
        if self.cnn_keys:
            ch, hw = 32 * int(channels_multiplier), conv_hw(screen_size)
            self.fc = nn.Linear(int(in_dim), hw * hw * ch)
            self.fc.map_hwc = (hw, hw, ch)
            self.deconvs = nn.ModuleList([nn.ConvTranspose2d(ch, ch, 3, stride=1) for _ in range(3)] +
                                         [nn.ConvTranspose2d(ch, sum(self.cnn_channels), 4, stride=2)])
        if self.mlp_keys:
            self.mlp = MLP(int(in_dim), [int(dense_units)] * int(mlp_layers), None, "relu")
            self.mlp_out = nn.Linear(self.mlp.output_dim, sum(self.mlp_dims))

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        lead = features.shape[:-1]
        if self.deconvs is not None:
            hw, _, ch = self.fc.map_hwc
            x = dense(features, self.fc).reshape(-1, ch, hw, hw)
            for layer in self.deconvs[:-1]:
                x = F.relu(conv_transpose(x, layer))
            x = conv_transpose(x, self.deconvs[-1])
            x = x.reshape(*lead, *x.shape[1:])
            for k, part in zip(self.cnn_keys, x.split(self.cnn_channels, dim=-3)):
                out[k] = part
        if self.mlp is not None:
            v = dense(mlp(features, self.mlp), self.mlp_out)
            for k, part in zip(self.mlp_keys, v.split(self.mlp_dims, dim=-1)):
                out[k] = part
        return out


class SACAEAgent(SACAgent):
    """SAC's four trees over the encoder's features, plus ``encoder``,
    ``decoder`` and ``target_encoder`` (a copy of the encoder, moved by
    Polyak averaging)."""

    def __init__(self, encoder: SACAEEncoder, decoder: SACAEDecoder, target_encoder: SACAEEncoder, actor: SACActor,
                 critic: SACCritics, target_critic: SACCritics, alpha: float):
        super().__init__(actor, critic, target_critic, alpha)
        self.encoder, self.decoder, self.target_encoder = encoder, decoder, target_encoder
        self.target_encoder.load_state_dict(self.encoder.state_dict())
        self.target_encoder.requires_grad_(False)


def build_agent(cfg, obs_space, action_space, agent_state: Optional[Dict[str, Any]] = None,
                device: torch.device | str = "cpu") -> Tuple[SACAEAgent, float]:
    """``(agent, target_entropy)`` of ``cfg`` on ``device``: from the seed,
    or from ``agent_state``, a checkpoint's ``agent`` (either package's)."""
    import numpy as np

    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    act_dim = int(prod(action_space.shape))
    low = np.asarray(action_space.low, np.float32).reshape(-1)
    high = np.asarray(action_space.high, np.float32).reshape(-1)
    screen = int(cfg.env.screen_size)
    enc_cfg, dec_cfg = cfg.algo.encoder, cfg.algo.decoder
    torch.manual_seed(int(cfg.seed or 0))

    def encoder() -> SACAEEncoder:
        return SACAEEncoder(cnn_keys, mlp_keys, sum(int(prod(obs_space[k].shape[:-2])) for k in cnn_keys), screen,
                            sum(int(prod(obs_space[k].shape)) for k in mlp_keys), int(enc_cfg.features_dim),
                            int(enc_cfg.cnn_channels_multiplier), int(enc_cfg.dense_units), int(enc_cfg.mlp_layers))

    enc = encoder()
    dec_cnn, dec_mlp = list(cfg.algo.cnn_keys.decoder), list(cfg.algo.mlp_keys.decoder)
    dec = SACAEDecoder(dec_cnn, [int(prod(obs_space[k].shape[:-2])) for k in dec_cnn], dec_mlp,
                       [int(prod(obs_space[k].shape)) for k in dec_mlp], enc.output_dim,
                       int(dec_cfg.cnn_channels_multiplier), screen, int(dec_cfg.dense_units), int(dec_cfg.mlp_layers))
    actor = SACActor(enc.output_dim, act_dim, int(cfg.algo.hidden_size), low, high, LOG_STD_MIN)

    def critic() -> SACCritics:
        return SACCritics(int(cfg.algo.critic.n), enc.output_dim + act_dim, int(cfg.algo.hidden_size))

    for module in (enc, dec, actor):
        lecun_normal_(module)
        for m in module.modules():
            if isinstance(m, nn.ConvTranspose2d):
                # flax's lecun_normal over a transposed kernel's fan-in
                # [kh, kw, in]: torch's [in, out, kh, kw] holds it on dims 0, 2, 3
                std = (1.0 / (m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3])) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
                nn.init.zeros_(m.bias)
    agent = SACAEAgent(enc, dec, encoder(), actor, critic(), critic(), float(cfg.algo.alpha.alpha))
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import load_trees, sac_ae_spec

        load_trees(sac_ae_spec(agent), agent_state)
    return agent.to(device), -float(act_dim)
