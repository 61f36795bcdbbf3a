"""Plan2Explore-DV3 agent (counterpart of ``sheeprl_tpu/algos/p2e_dv3/agent.py``):
DreamerV3's four modules as the task's, an exploration actor, a critic
and its target per exploration critic, and an ensemble of MLPs whose
disagreement on the next stochastic state is the intrinsic reward.

The ensemble keeps its N members' weights stacked on a leading axis, each
layer one ``[N, in, out]`` tensor, as the JAX package keeps them for
``jax.vmap``: a layer of all members is one batched product, not N.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    Critic,
    WorldModel,
    _eps,
    _latent_state_size,
    _trunc_normal_fan_avg_,
    build_agent as build_dv3_agent,
    init_weights,
    make_actor,
    make_critic,
)
from sheeprl_tpu_torch.models.blocks import get_activation


class Ensemble(nn.Module):
    """N MLPs ``(latent, action) -> next stochastic state`` (or, for
    Plan2Explore-DV1, next embedding), each ``[Dense -> LayerNorm? -> act] x
    layers`` and a dense head, as the JAX ``Ensemble``: with ``layer_norm``
    each hidden Dense has no bias (P2E-DV3's ``Dense(no bias) -> LayerNorm
    -> silu``), without one it has its bias back (P2E-DV2's, and P2E-DV1's
    with ``act="elu"``).  ``act`` defaults to silu whatever
    ``ensembles.dense_act`` says, as the JAX families that do not pass it
    (P2E-DV3, P2E-DV2) leave it.  Returns ``[N, ..., output_dim]``."""

    def __init__(self, n: int, in_features: int, output_dim: int, dense_units: int, mlp_layers: int,
                 eps: float = 1e-3, act: str = "silu", layer_norm: bool = True):
        super().__init__()
        self.n, self.units, self.eps, self.layer_norm = n, dense_units, eps, layer_norm
        sizes = [in_features] + [dense_units] * mlp_layers
        self.kernels = nn.ParameterList(nn.Parameter(torch.empty(n, sizes[i], sizes[i + 1]))
                                        for i in range(mlp_layers))
        norms = mlp_layers if layer_norm else 0
        self.scales = nn.ParameterList(nn.Parameter(torch.ones(n, dense_units)) for _ in range(norms))
        self.biases = nn.ParameterList(nn.Parameter(torch.zeros(n, dense_units)) for _ in range(norms))
        # the hidden Dense layers' biases, without the LayerNorm
        self.dense_biases = nn.ParameterList(nn.Parameter(torch.zeros(n, dense_units))
                                             for _ in range(mlp_layers - norms))
        self.out_kernel = nn.Parameter(torch.empty(n, sizes[-1], output_dim))
        self.out_bias = nn.Parameter(torch.zeros(n, output_dim))
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.reshape(-1, x.shape[-1])
        for i, kernel in enumerate(self.kernels):
            if i == 0:
                # every member reads the same input: one product against the
                # members' kernels side by side, [M, in] @ [in, N * units]
                h = (h @ kernel.transpose(0, 1).reshape(kernel.shape[1], -1)).reshape(h.shape[0], self.n, -1)
                h = h.transpose(0, 1)
            else:
                h = torch.bmm(h, kernel)
            if self.layer_norm:
                h = F.layer_norm(h, (self.units,), eps=self.eps) * self.scales[i][:, None] + self.biases[i][:, None]
            else:
                h = h + self.dense_biases[i][:, None]
            h = self.act(h)
        if not len(self.kernels):
            h = h.expand(self.n, *h.shape)
        out = torch.baddbmm(self.out_bias[:, None], h, self.out_kernel)
        return out.reshape(self.n, *lead, out.shape[-1])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, zero_head: bool) -> None:
        """Each member as flax initializes one: truncated-normal fan-avg
        kernels, and the head's zero under Hafner's initialization."""
        for kernel in list(self.kernels) + ([] if zero_head else [self.out_kernel]):
            for member in kernel:
                _trunc_normal_fan_avg_(member, member.shape[0], member.shape[1], generator)
        if zero_head:
            self.out_kernel.zero_()
        for p in list(self.scales):
            p.fill_(1.0)
        for p in list(self.biases) + list(self.dense_biases) + [self.out_bias]:
            p.zero_()


class ExplorationCritic(nn.Module):
    """One exploration critic and its target, the JAX tree's ``module`` and
    ``target_module``."""

    def __init__(self, critic: Critic):
        super().__init__()
        self.module = critic
        self.target_module = copy.deepcopy(critic)
        self.target_module.requires_grad_(False)


def exploration_critics_spec(cfg) -> List[Tuple[str, float, str]]:
    """Sorted ``(name, weight, reward_type)`` of every exploration critic
    with a positive weight; at least one must be intrinsic."""
    spec = []
    for name in sorted(cfg.algo.critics_exploration):
        c = cfg.algo.critics_exploration[name]
        if c.weight > 0:
            spec.append((name, float(c.weight), str(c.reward_type)))
    if not any(reward_type == "intrinsic" for _, _, reward_type in spec):
        raise RuntimeError("You must specify at least one intrinsic critic (`reward_type='intrinsic'`)")
    return spec


#: the checkpoint keys of the agent's trees, the JAX package's
TREES = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
         "critics_exploration", "ensembles")


class P2EAgent(NamedTuple):
    """Plan2Explore-DV3's modules under the JAX package's tree names."""

    world_model: WorldModel
    actor_task: Actor
    critic_task: Critic
    target_critic_task: Critic
    actor_exploration: Actor
    critics_exploration: nn.ModuleDict
    ensembles: Ensemble

    def optimizer_configs(self, cfg) -> Dict[str, Any]:
        """Six kinds of optimizer, as the JAX package's exploration builds
        them: the world model's, the task actor's and critic's, the
        exploration actor's (``algo.actor``), the ensembles' and one per
        exploration critic (``algo.critic``), named
        ``critics_exploration/<name>``."""
        out = {"world_model": cfg.algo.world_model, "actor_task": cfg.algo.actor, "critic_task": cfg.algo.critic,
               "actor_exploration": cfg.algo.actor, "ensembles": cfg.algo.ensembles}
        out.update({f"critics_exploration/{name}": cfg.algo.critic for name in self.critics_exploration})
        return out

    def initial_moments(self, device: torch.device | str = "cpu") -> Dict[str, Any]:
        """The task's Moments and one per exploration critic."""
        from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state

        return {"task": init_moments_state(device),
                "exploration": {name: init_moments_state(device) for name in self.critics_exploration}}

    def _module(self, name: str) -> nn.Module:
        group, _, critic = name.partition("/")
        return self.critics_exploration[critic].module if critic else getattr(self, group)

    def parameters_of(self, name: str) -> List[nn.Parameter]:
        return list(self._module(name).parameters())

    def optimizer_spec(self, name: str) -> Any:
        from sheeprl_tpu_torch.interop.flax_params import p2e_spec

        group, _, critic = name.partition("/")
        spec = p2e_spec(self)[group]
        return spec[critic]["module"] if critic else spec

    def trees(self) -> Dict[str, Any]:
        """The seven trees as the JAX package's checkpoints hold them."""
        from sheeprl_tpu_torch.interop.flax_params import dump_trees, p2e_spec

        return dump_trees(p2e_spec(self))


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> P2EAgent:
    """DreamerV3's modules as the task's (from the seed), then from a
    generator seeded by ``cfg.seed + 17`` the exploration actor, each
    exploration critic (its target a copy) and the ensemble; all seven trees
    from ``state`` when given.  flax's random init cannot be reproduced
    here, so parity with the JAX package goes through converted weights."""
    dv3 = build_dv3_agent(actions_dim, is_continuous, cfg, obs_space, None, "cpu")
    generator = torch.Generator().manual_seed(int(cfg.seed or 0) + 17)
    actor_exploration = make_actor(actions_dim, is_continuous, cfg)
    init_weights(None, actor_exploration, None, generator)
    critics = nn.ModuleDict()
    for name, _, _ in exploration_critics_spec(cfg):
        critic = make_critic(cfg)
        init_weights(None, None, critic, generator)
        critics[name] = ExplorationCritic(critic)
    wm_cfg, ens_cfg = cfg.algo.world_model, cfg.algo.ensembles
    stoch_flat = wm_cfg.stochastic_size * wm_cfg.discrete_size
    ensembles = Ensemble(int(ens_cfg.n), _latent_state_size(cfg) + int(sum(actions_dim)), stoch_flat,
                         int(ens_cfg.dense_units), int(ens_cfg.mlp_layers), _eps(cfg))
    ensembles.reset_parameters(generator, bool(cfg.algo.hafner_initialization))
    agent = P2EAgent(*dv3, actor_exploration, critics, ensembles)
    if state is not None:
        from sheeprl_tpu_torch.interop.flax_params import load_trees, p2e_spec

        load_trees(p2e_spec(agent), state)
    return P2EAgent(*(m.to(device) for m in agent))
