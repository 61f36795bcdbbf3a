"""The DroQ agent (counterpart of ``sheeprl_tpu/algos/droq/agent.py``):
SAC's actor, and critics with dropout and LayerNorm
(https://arxiv.org/abs/2110.02034).

:class:`DroQCritics` keeps the N members stacked as flax's ``nn.vmap``
stores them: per hidden layer ``Dense -> Dropout -> LayerNorm (eps 1e-6,
flax's default) -> ReLU``, then ``Dense(1)``.  Dropout takes pre-drawn
keep-masks, ``[N, B, H]`` booleans per hidden layer, one set per call (each
member its own, as ``split_rngs={"dropout": True}`` draws them); kept
units are scaled by ``1 / (1 - rate)``, as flax's ``Dropout`` does.
Without masks the pass is deterministic (the target critic's).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent, SACCritics, spaces_dims
from sheeprl_tpu_torch.models.blocks import lecun_normal_

LAYER_NORM_EPS = 1e-6


class DroQCritics(SACCritics):
    """``forward(obs, actions, masks=None) -> [..., N]``."""

    def __init__(self, n: int, in_dim: int, hidden_size: int, dropout: float):
        super().__init__(n, in_dim, hidden_size)
        self.dropout = float(dropout)
        self.hidden_size = int(hidden_size)
        self.norm_scales = nn.ParameterList(nn.Parameter(torch.ones(self.n, hidden_size)) for _ in range(2))
        self.norm_biases = nn.ParameterList(nn.Parameter(torch.zeros(self.n, hidden_size)) for _ in range(2))

    def mask_shape(self, rows: int) -> Tuple[int, int, int]:
        return (self.n, int(rows), self.hidden_size)

    def draw_masks(self, rows: int, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
        """One call's keep-masks, a ``[N, rows, H]`` boolean per hidden layer."""
        keep = 1.0 - self.dropout
        return [torch.rand(self.mask_shape(rows), generator=generator, device=device) < keep for _ in range(2)]

    def forward(self, obs: torch.Tensor, actions: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        dt = torch.promote_types(obs.dtype, actions.dtype)
        x = torch.cat([obs.to(dt), actions.to(dt)], dim=-1)
        lead = tuple(x.shape[:-1])
        h = x.reshape(-1, x.shape[-1])
        keep = 1.0 - self.dropout
        for i in range(2):
            h = self.layer(h, i)
            if masks is not None and self.dropout > 0:
                h = torch.where(masks[i], h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
            scale, bias = self.norm_scales[i].to(h.dtype), self.norm_biases[i].to(h.dtype)
            h = F.relu(F.layer_norm(h, (h.shape[-1],), eps=LAYER_NORM_EPS) * scale[:, None] + bias[:, None])
        return self.head(h, lead)


def build_agent(cfg, obs_space, action_space, agent_state: Optional[Dict[str, Any]] = None,
                device: torch.device | str = "cpu") -> Tuple[SACAgent, float]:
    """``(agent, target_entropy)``: SAC's actor and ``log_alpha`` with
    :class:`DroQCritics`, from the seed or a checkpoint's ``agent``."""
    obs_dim, act_dim, low, high = spaces_dims(cfg, obs_space, action_space)
    torch.manual_seed(int(cfg.seed or 0))
    actor = SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size), low, high)
    lecun_normal_(actor)

    def critic() -> DroQCritics:
        return DroQCritics(int(cfg.algo.critic.n), obs_dim + act_dim, int(cfg.algo.critic.hidden_size),
                           float(cfg.algo.critic.dropout))

    agent = SACAgent(actor, critic(), critic(), float(cfg.algo.alpha.alpha))
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_params import load_trees, sac_spec

        load_trees(sac_spec(agent), agent_state)
    return agent.to(device), -float(act_dim)
