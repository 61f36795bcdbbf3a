"""The SAC agent (counterpart of ``sheeprl_tpu/algos/sac/agent.py``): the
tanh-Gaussian actor, the critic ensemble and the entropy coefficient.

- :class:`SACActor`: a ReLU stack, a mean and a log-std head, the log-std
  clipped to ``[log_std_min, 2]``; actions are ``tanh(x) * scale + bias``
  with ``scale``/``bias`` from the action space's bounds.
  :meth:`~SACActor.sample_and_log_prob` takes the standard-normal draw
  ``eps`` (pre-drawn, so that tests can inject the JAX draws).
- :class:`SACCritics`: N Q-networks kept stacked as flax's ``nn.vmap``
  stores them, kernels ``[N, in, out]`` and biases ``[N, out]``, one batched
  product a layer; the output is ``[..., N]``.
- :class:`SACAgent`: ``actor``, ``critic``, ``target_critic`` and
  ``log_alpha``, the four trees of the JAX package's params.

Every dense layer computes in the promotion of its input's and its
parameters' dtypes, as a flax ``Dense`` with ``dtype=None`` does: under
``bf16-mixed`` a bf16 layer fed the fp32 actions of the tanh squash runs in
fp32, as it does in the JAX step.
"""

from __future__ import annotations

import math
from math import prod
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.models.blocks import lecun_normal_

LOG_STD_MAX = 2.0
LOG_STD_MIN = -5.0


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` in the promotion of the input's and the weights' dtypes."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class SACActor(nn.Module):
    """``forward(obs) -> (mean, std)``; the action-space rescale is held as
    fp32 buffers (constants of the JAX module, not params)."""

    def __init__(self, in_dim: int, action_dim: int, hidden_size: int, action_low: Sequence[float],
                 action_high: Sequence[float], log_std_min: float = LOG_STD_MIN):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(in_dim, hidden_size), nn.Linear(hidden_size, hidden_size)])
        self.fc_mean = nn.Linear(hidden_size, action_dim)
        self.fc_logstd = nn.Linear(hidden_size, action_dim)
        self.log_std_min = float(log_std_min)
        # the bounds themselves, as the JAX module's ``action_low/high``
        # attributes (the conservative Q penalty draws its proposals in them)
        self.action_low = np.array(action_low, np.float32).reshape(-1)
        self.action_high = np.array(action_high, np.float32).reshape(-1)
        low, high = torch.tensor(self.action_low), torch.tensor(self.action_high)
        self.register_buffer("action_scale", (high - low) / 2.0)
        self.register_buffer("action_bias", (high + low) / 2.0)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for layer in self.dense:
            x = F.relu(dense(x, layer))
        mean = dense(x, self.fc_mean)
        log_std = dense(x, self.fc_logstd)
        return mean, torch.exp(torch.clamp(log_std, self.log_std_min, LOG_STD_MAX))

    def sample_and_log_prob(self, obs: torch.Tensor, eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reparametrized action for the standard-normal ``eps`` (fp32,
        ``mean``'s shape) and its log-prob ``[..., 1]`` under the tanh
        change of variables."""
        mean, std = self(obs)
        x_t = mean + std * eps
        y_t = torch.tanh(x_t)
        action = y_t * self.action_scale + self.action_bias
        log_prob = -((x_t - mean) ** 2) / (2 * std**2) - torch.log(std) - 0.5 * math.log(2 * math.pi)
        log_prob = log_prob - torch.log(self.action_scale * (1 - y_t**2) + 1e-6)
        return action, log_prob.sum(dim=-1, keepdim=True)

    def greedy_action(self, obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self(obs)
        return torch.tanh(mean) * self.action_scale + self.action_bias


class SACCritics(nn.Module):
    """N ReLU MLPs ``(obs, action) -> Q`` stacked on a leading axis: layer
    ``i`` is ``kernels[i]`` ``[N, in, out]`` and ``biases[i]`` ``[N, out]``
    (flax's ``Vmap_QNetwork_0/MLP_0/Dense_i``).  Returns ``[..., N]``."""

    def __init__(self, n: int, in_dim: int, hidden_size: int, layers: int = 2):
        super().__init__()
        self.n = int(n)
        sizes = [int(in_dim)] + [int(hidden_size)] * layers + [1]
        self.kernels = nn.ParameterList(nn.Parameter(torch.empty(self.n, a, b)) for a, b in zip(sizes[:-1], sizes[1:]))
        self.biases = nn.ParameterList(nn.Parameter(torch.zeros(self.n, b)) for b in sizes[1:])
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``lecun_normal`` on each member's kernels, zero biases."""
        for kernel in self.kernels:
            std = math.sqrt(1.0 / kernel.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=generator)
        for bias in self.biases:
            bias.zero_()

    def layer(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """Layer ``i`` on ``[N, M, in]`` (or the shared ``[M, in]`` every
        member reads, for the first), in the promoted dtype: ``[N, M, out]``."""
        kernel, bias = self.kernels[i], self.biases[i]
        dt = torch.promote_types(h.dtype, kernel.dtype)
        h, kernel, bias = h.to(dt), kernel.to(dt), bias.to(dt)
        if h.dim() == 2:
            # every member reads the same rows: one product against the
            # members' kernels side by side, [M, in] @ [in, N * out]
            out = (h @ kernel.transpose(0, 1).reshape(kernel.shape[1], -1)).reshape(h.shape[0], self.n, -1)
            return out.transpose(0, 1) + bias[:, None]
        return torch.baddbmm(bias[:, None], h, kernel)

    def head(self, h: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
        """The output layer, as ``[..., N]``."""
        out = self.layer(h, len(self.kernels) - 1)
        return out[..., 0].transpose(0, 1).reshape(*lead, self.n)

    def forward(self, obs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(obs.dtype, actions.dtype)
        x = torch.cat([obs.to(dt), actions.to(dt)], dim=-1)
        lead = tuple(x.shape[:-1])
        h = x.reshape(-1, x.shape[-1])
        for i in range(len(self.kernels) - 1):
            h = F.relu(self.layer(h, i))
        return self.head(h, lead)


class SACAgent(nn.Module):
    """The four trees: ``actor``, ``critic``, ``target_critic`` (a copy of
    the critic, moved by Polyak averaging) and ``log_alpha`` ``[1]``."""

    def __init__(self, actor: SACActor, critic: nn.Module, target_critic: nn.Module, alpha: float):
        super().__init__()
        self.actor, self.critic, self.target_critic = actor, critic, target_critic
        self.target_critic.load_state_dict(self.critic.state_dict())
        self.target_critic.requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], dtype=torch.float32)))


def spaces_dims(cfg, obs_space, action_space) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """``(obs_dim, act_dim, low, high)``: the flat concatenation of the
    vector keys and the action space's bounds."""
    obs_dim = int(sum(prod(obs_space[k].shape) for k in cfg.algo.mlp_keys.encoder))
    act_dim = int(prod(action_space.shape))
    low = np.asarray(action_space.low, np.float32).reshape(-1)
    high = np.asarray(action_space.high, np.float32).reshape(-1)
    return obs_dim, act_dim, low, high


def build_agent(cfg, obs_space, action_space, agent_state: Optional[Dict[str, Any]] = None,
                device: torch.device | str = "cpu") -> Tuple[SACAgent, float]:
    """``(agent, target_entropy)`` of ``cfg`` on ``device``: from the seed,
    or from ``agent_state``, a checkpoint's ``agent`` (either package's).
    ``target_entropy`` is ``-act_dim``."""
    obs_dim, act_dim, low, high = spaces_dims(cfg, obs_space, action_space)
    torch.manual_seed(int(cfg.seed or 0))
    actor = SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size), low, high)
    lecun_normal_(actor)

    def critic() -> SACCritics:
        return SACCritics(int(cfg.algo.critic.n), obs_dim + act_dim, int(cfg.algo.critic.hidden_size))

    agent = SACAgent(actor, critic(), critic(), float(cfg.algo.alpha.alpha))
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import load_trees, sac_spec

        load_trees(sac_spec(agent), agent_state)
    return agent.to(device), -float(act_dim)
