"""The recurrent PPO agent (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/agent.py``): PPO's encoders, an optional
dense layer before the LSTM, the LSTM, an optional dense layer after it,
the actor's backbone and heads and the critic, laid out like the JAX
``RecurrentPPOAgent``'s flax tree (``interop/flax_params.py::
ppo_recurrent_spec``).

The LSTM is flax's ``OptimizedLSTMCell``: gates i, f, g, o; the input
kernels ``ii/if/ig/io`` without a bias, the hidden kernels ``hi/hf/hg/ho``
with one; ``c' = σ(f)·c + σ(i)·tanh(g)``, ``h' = σ(o)·tanh(c')``.  It runs
over a sequence as a Python loop of one step each; where ``resets`` is 1 the
carry is zeroed before the step (``reset_recurrent_state_on_done``).  The
eight kernels are eight ``nn.Linear``s, concatenated once a sequence into
one input product over all its steps and one hidden product a step.
Sampling takes pre-drawn noise (a standard-normal draw of the continuous
head, Gumbel noise of each categorical head) or draws it from a
``torch.Generator``; log-probs and entropies are ``[L, B, 1]``.  The agent
computes in its parameters' dtype: callers run it under ``call_cast``.
"""

from __future__ import annotations

import math
from math import prod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from sheeprl_tpu_torch.algos.ppo.agent import gumbel_like
from sheeprl_tpu_torch.models.blocks import MLP, NatureCNN, lecun_normal_
from sheeprl_tpu_torch.ops.distributions import Categorical, Normal

INPUT_GATES = ("ii", "if", "ig", "io")
HIDDEN_GATES = ("hi", "hf", "hg", "ho")


class ResetLSTM(nn.Module):
    """flax's ``OptimizedLSTMCell`` scanned over ``[L, B, F]`` with the
    carry zeroed where ``resets`` is 1, before each step."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.gates = nn.ModuleDict({k: nn.Linear(input_size, hidden_size, bias=False) for k in INPUT_GATES})
        self.gates.update({k: nn.Linear(hidden_size, hidden_size) for k in HIDDEN_GATES})

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's defaults: ``lecun_normal`` input kernels, orthogonal hidden
        kernels, zero biases."""
        for k in INPUT_GATES:
            w = self.gates[k].weight
            std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        for k in HIDDEN_GATES:
            nn.init.orthogonal_(self.gates[k].weight, generator=generator)
            nn.init.zeros_(self.gates[k].bias)

    def forward(self, x: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor,
                resets: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        w_in = torch.cat([self.gates[k].weight for k in INPUT_GATES])
        w_hidden = torch.cat([self.gates[k].weight for k in HIDDEN_GATES])
        b_hidden = torch.cat([self.gates[k].bias for k in HIDDEN_GATES])
        projected = x @ w_in.t()  # every step's input product at once
        h, c, outs = hx, cx, []
        for t in range(x.shape[0]):
            if resets is not None:
                keep = 1 - resets[t].to(h.dtype)
                h, c = h * keep, c * keep
            i, f, g, o = torch.chunk(projected[t] + torch.addmm(b_hidden, h, w_hidden.t()), 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs), (h, c)


class RecurrentPPOAgent(nn.Module):
    """``forward(obs, prev_actions, hx, cx, resets=None, actions=None,
    greedy=False, noise=None, generator=None) -> (actions, log_prob,
    entropy, values, (hx, cx))`` over ``[L, B, ...]`` sequences."""

    def __init__(self, actions_dim: Sequence[int], is_continuous: bool, cnn_keys: Sequence[str],
                 mlp_keys: Sequence[str], cnn_channels: int, screen_hw: Tuple[int, int], mlp_input_dim: int,
                 encoder_cfg: Any, rnn_cfg: Any, actor_cfg: Any, critic_cfg: Any):
        super().__init__()
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.cnn_keys, self.mlp_keys = list(cnn_keys), list(mlp_keys)
        enc = encoder_cfg
        features = 0
        self.cnn_encoder = None
        if self.cnn_keys:
            self.cnn_encoder = NatureCNN(cnn_channels, screen_hw, enc["cnn_features_dim"])
            features += self.cnn_encoder.features_dim
        self.mlp_encoder = None
        if self.mlp_keys:
            self.mlp_encoder = MLP(mlp_input_dim, [enc["dense_units"]] * (enc.get("mlp_layers", 1) or 1),
                                   enc["mlp_features_dim"], enc.get("dense_act", "relu"), enc.get("layer_norm", True))
            features += self.mlp_encoder.output_dim
        rnn_in = features + sum(self.actions_dim)
        hidden = int(rnn_cfg["lstm"]["hidden_size"])
        pre, post = rnn_cfg["pre_rnn_mlp"], rnn_cfg["post_rnn_mlp"]
        self.pre_mlp = None
        if pre["apply"]:
            self.pre_mlp = MLP(rnn_in, [pre["dense_units"]], None, pre.get("activation", "relu"),
                               pre.get("layer_norm", False))
            rnn_in = self.pre_mlp.output_dim
        self.lstm = ResetLSTM(rnn_in, hidden)
        out = hidden
        self.post_mlp = None
        if post["apply"]:
            self.post_mlp = MLP(hidden, [post["dense_units"]], None, post.get("activation", "relu"),
                                post.get("layer_norm", False))
            out = self.post_mlp.output_dim
        a, c = actor_cfg, critic_cfg
        self.actor_backbone = MLP(out, [a["dense_units"]] * a["mlp_layers"], None, a["dense_act"], a["layer_norm"])
        head_in = self.actor_backbone.output_dim
        if self.is_continuous:
            self.actor_heads = nn.ModuleList([nn.Linear(head_in, sum(self.actions_dim) * 2)])
        else:
            self.actor_heads = nn.ModuleList(nn.Linear(head_in, d) for d in self.actions_dim)
        self.critic = MLP(out, [c["dense_units"]] * c["mlp_layers"], 1, c["dense_act"], c["layer_norm"])
        lecun_normal_(self)
        self.lstm.reset_parameters()

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``[L, B, F]`` features of ``[L, B, ...]`` observations (pixels
        0-255 scaled by 1/255)."""
        feats = []
        if self.cnn_encoder is not None:
            x = torch.cat([obs[k] for k in self.cnn_keys], dim=-3)
            x = x if x.is_floating_point() else x.float()  # raw uint8 pixels from the stager
            lead = x.shape[:2]
            feats.append(self.cnn_encoder((x / 255.0).reshape(-1, *x.shape[2:])).reshape(*lead, -1))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(torch.cat([obs[k] for k in self.mlp_keys], dim=-1)))
        return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]

    def rnn(self, obs, prev_actions, hx, cx, resets=None):
        x = torch.cat([self.features(obs), prev_actions.to(hx.dtype)], dim=-1)
        if self.pre_mlp is not None:
            x = self.pre_mlp(x)
        out, state = self.lstm(x, hx, cx, resets)
        if self.post_mlp is not None:
            out = self.post_mlp(out)
        return out, state

    def get_values(self, obs, prev_actions, hx, cx, resets=None) -> torch.Tensor:
        return self.critic(self.rnn(obs, prev_actions, hx, cx, resets)[0])

    def forward(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor,
                resets: Optional[torch.Tensor] = None, actions: Optional[torch.Tensor] = None, greedy: bool = False,
                noise: Optional[Any] = None, generator: Optional[torch.Generator] = None):
        """With ``actions``, their log-prob and entropy (the update);
        otherwise sampled with ``noise`` (a standard-normal ``[L, B, A]``
        for the continuous head, a list of Gumbel ``[L, B, d_i]`` per
        categorical head; drawn from ``generator`` when None), or the mode
        with ``greedy``."""
        out, state = self.rnn(obs, prev_actions, hx, cx, resets)
        values = self.critic(out)
        pre = self.actor_backbone(out)
        outs = [head(pre) for head in self.actor_heads]
        if self.is_continuous:
            mean, log_std = outs[0].chunk(2, dim=-1)
            dist = Normal(mean, log_std.exp(), event_dims=1)
            if actions is None:
                if greedy:
                    actions = dist.mode
                else:
                    if noise is None:
                        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
                    actions = dist.rsample(noise)
            return actions, dist.log_prob(actions)[..., None], dist.entropy()[..., None], values, state
        sampled: List[torch.Tensor] = []
        log_probs: List[torch.Tensor] = []
        entropies: List[torch.Tensor] = []
        split = actions.split(1, dim=-1) if actions is not None else [None] * len(outs)
        for i, logits in enumerate(outs):
            dist = Categorical(logits)
            if split[i] is None:
                if greedy:
                    idx = logits.argmax(dim=-1)
                else:
                    g = noise[i] if noise is not None else gumbel_like(logits.shape, generator, logits.device)
                    idx = dist.sample(g)
                act = idx[..., None].float()
            else:
                act = split[i]
                idx = act[..., 0].long()
            sampled.append(act)
            log_probs.append(dist.log_prob(idx)[..., None])
            entropies.append(dist.entropy()[..., None])
        return (torch.cat(sampled, dim=-1), torch.cat(log_probs, dim=-1).sum(-1, keepdim=True),
                torch.cat(entropies, dim=-1).sum(-1, keepdim=True), values, state)


def prev_actions_of(actions: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool) -> torch.Tensor:
    """The LSTM's previous-action input from the agent's ``[..., A]``
    actions: the actions themselves for the continuous head, one-hot per
    categorical head otherwise."""
    if is_continuous:
        return actions.float()
    return torch.cat([torch.nn.functional.one_hot(actions[..., j].long(), d).float()
                      for j, d in enumerate(actions_dim)], dim=-1)


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                agent_state: Optional[Dict[str, Any]] = None, device: torch.device | str = "cpu") -> RecurrentPPOAgent:
    """The agent of ``cfg`` on ``device``: from the seed, or from
    ``agent_state``, a flax param tree (a checkpoint's ``agent``, either
    package's)."""
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    channels, screen_hw = 0, (0, 0)
    for k in cnn_keys:
        shape = tuple(obs_space[k].shape)
        channels += int(prod(shape[:-2]))
        screen_hw = shape[-2:]
    mlp_input_dim = int(sum(prod(obs_space[k].shape) for k in mlp_keys))
    torch.manual_seed(int(cfg.seed or 0))
    agent = RecurrentPPOAgent(actions_dim, is_continuous, cnn_keys, mlp_keys, channels, screen_hw, mlp_input_dim,
                              cfg.algo.encoder, cfg.algo.rnn, cfg.algo.actor, cfg.algo.critic)
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import ppo_recurrent_from_flax

        ppo_recurrent_from_flax(agent_state, agent)
    return agent.to(device)
