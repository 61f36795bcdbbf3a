"""The PPO agent (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``): a
feature extractor (NatureCNN over the channel-concat of the pixel keys, a
dense stack over the concat of the vector keys), the actor's backbone and
heads and the critic, as one ``nn.Module`` laid out like the flax tree
(``interop/flax_params.py::ppo_spec``).

Action families: ``discrete`` and multi-discrete (one categorical head per
sub-action), ``normal`` and ``tanh_normal`` (one head emitting the mean and
the log-std).  Sampling takes pre-drawn noise (a standard-normal draw of the
continuous head, Gumbel noise of each categorical head), or draws it from a
``torch.Generator``.  The log-prob and entropy are ``[N, 1]`` in every
family; the JAX agent returns ``[N]`` for the continuous ones (ROADMAP.md,
Queue 3).  Each part computes in the promotion of its input's and its
weights' dtypes, as the flax modules do under the precision policy.
"""

from __future__ import annotations

from math import prod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from sheeprl_tpu_torch.models.blocks import MLP, NatureCNN, lecun_normal_
from sheeprl_tpu_torch.ops.distributions import Categorical, Normal, TanhNormal


def promoted_call(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` in the promotion of ``x``'s and the module's parameter
    dtype, as a flax module with ``dtype=None`` computes: bf16 weights fed
    fp32 pixels (or the fp32 rollout's observations under ``bf16-true``)
    run in fp32 on the weights' bf16 values."""
    from sheeprl_tpu_torch.parallel.precision import call_cast

    param_dtype = next(module.parameters()).dtype
    dt = torch.promote_types(x.dtype, param_dtype)
    if dt == param_dtype:
        return module(x.to(dt))
    return call_cast((module,), dt, lambda: module(x.to(dt)))


def gumbel_like(shape: Tuple[int, ...], generator: Optional[torch.Generator], device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device).clamp_(torch.finfo(torch.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


class PPOAgent(nn.Module):
    """Encoders + actor + critic; ``forward`` returns ``(actions, log_prob,
    entropy, value)``."""

    def __init__(self, actions_dim: Sequence[int], is_continuous: bool, distribution: str, cnn_keys: Sequence[str],
                 mlp_keys: Sequence[str], cnn_channels: int, screen_hw: Tuple[int, int], mlp_input_dim: int,
                 encoder_cfg: Any, actor_cfg: Any, critic_cfg: Any):
        super().__init__()
        dist = str(distribution).lower()
        if dist not in ("auto", "normal", "tanh_normal", "discrete"):
            raise ValueError(
                f"The distribution must be one of: `auto`, `discrete`, `normal` and `tanh_normal`. Found: {dist}")
        if dist == "discrete" and is_continuous:
            raise ValueError("You have chosen a discrete distribution but `is_continuous` is true")
        if dist in ("normal", "tanh_normal") and not is_continuous:
            raise ValueError("You have chosen a continuous distribution but `is_continuous` is false")
        self.dist = ("normal" if is_continuous else "discrete") if dist == "auto" else dist
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
            if enc["mlp_layers"] == 0:
                features += int(mlp_input_dim)
            else:
                self.mlp_encoder = MLP(mlp_input_dim, [enc["dense_units"]] * enc["mlp_layers"],
                                       enc["mlp_features_dim"], enc["dense_act"], enc["layer_norm"])
                features += self.mlp_encoder.output_dim
        a, c = actor_cfg, critic_cfg
        self.actor_backbone = MLP(features, [a["dense_units"]] * a["mlp_layers"], None, a["dense_act"],
                                  a["layer_norm"])
        head_in = self.actor_backbone.output_dim
        if self.is_continuous:
            self.actor_heads = nn.ModuleList([nn.Linear(head_in, sum(self.actions_dim) * 2)])
        else:
            self.actor_heads = nn.ModuleList(nn.Linear(head_in, d) for d in self.actions_dim)
        self.critic = MLP(features, [c["dense_units"]] * c["mlp_layers"], 1, c["dense_act"], c["layer_norm"])
        lecun_normal_(self)

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            x = torch.cat([obs[k] for k in self.cnn_keys], dim=-3)
            feats.append(promoted_call(self.cnn_encoder, x.float() / 255.0))
        if self.mlp_keys:
            x = torch.cat([obs[k] for k in self.mlp_keys], dim=-1)
            feats.append(promoted_call(self.mlp_encoder, x) if self.mlp_encoder is not None else x)
        if len(feats) == 1:
            return feats[0]
        dt = torch.promote_types(feats[0].dtype, feats[1].dtype)
        return torch.cat([f.to(dt) for f in feats], dim=-1)

    def get_values(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return promoted_call(self.critic, self.features(obs))

    def forward(self, obs: Dict[str, torch.Tensor], actions: Optional[torch.Tensor] = None, greedy: bool = False,
                noise: Optional[Any] = None, generator: Optional[torch.Generator] = None):
        """With ``actions``, their log-prob and entropy (the update);
        otherwise sampled with ``noise`` (drawn from ``generator`` when None:
        a standard-normal ``[N, A]`` for a continuous head, a list of Gumbel
        ``[N, d_i]`` per categorical head) or the mode with ``greedy``."""
        feat = self.features(obs)
        value = promoted_call(self.critic, feat)
        pre = promoted_call(self.actor_backbone, feat) if len(self.actor_backbone.dense) else feat
        outs = [promoted_call(head, pre) for head in self.actor_heads]
        if self.is_continuous:
            mean, log_std = outs[0].chunk(2, dim=-1)
            std = log_std.exp()
            dist = TanhNormal(mean, std, event_dims=1) if self.dist == "tanh_normal" else Normal(mean, std,
                                                                                                event_dims=1)
            if actions is None:
                if greedy:
                    actions = dist.mode
                else:
                    if noise is None:
                        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
                    actions = dist.rsample(noise)
            log_prob = dist.log_prob(actions)
            # the tanh-normal's entropy has no closed form: -log_prob of the sample
            entropy = -log_prob if self.dist == "tanh_normal" else dist.entropy()
            return actions, log_prob[..., None], entropy[..., None], value
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
                torch.cat(entropies, dim=-1).sum(-1, keepdim=True), value)


def actions_dim_of(action_space) -> Tuple[Tuple[int, ...], bool, bool]:
    """``(actions_dim, is_continuous, is_multidiscrete)`` of an action space."""
    from sheeprl_tpu_torch.envs import spaces

    is_continuous = isinstance(action_space, spaces.Box)
    is_multidiscrete = isinstance(action_space, spaces.MultiDiscrete)
    dims = (action_space.shape if is_continuous
            else (action_space.nvec.tolist() if is_multidiscrete else [action_space.n]))
    return tuple(int(d) for d in dims), is_continuous, is_multidiscrete


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                agent_state: Optional[Dict[str, Any]] = None, device: torch.device | str = "cpu") -> PPOAgent:
    """The agent of ``cfg`` for ``obs_space`` on ``device``: from the seed
    (``torch.manual_seed(cfg.seed)``), or from ``agent_state``, a flax param
    tree (a checkpoint's ``agent``, the JAX package's or the port's)."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    channels, screen_hw = 0, (0, 0)
    for k in cnn_keys:
        shape = tuple(obs_space[k].shape)
        channels += int(prod(shape[:-2]))  # a frame stack's frames fold into the channels
        screen_hw = shape[-2:]
    mlp_input_dim = int(sum(prod(obs_space[k].shape) for k in mlp_keys))
    torch.manual_seed(int(cfg.seed or 0))
    agent = PPOAgent(actions_dim, is_continuous, cfg.distribution.type, cnn_keys, mlp_keys, channels, screen_hw,
                     mlp_input_dim, cfg.algo.encoder, cfg.algo.actor, cfg.algo.critic)
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import ppo_from_flax

        ppo_from_flax(agent_state, agent)
    return agent.to(device)
