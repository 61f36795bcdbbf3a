"""The A2C agent (counterpart of ``sheeprl_tpu/algos/a2c/agent.py``): PPO's
agent on vector observations only."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent
from sheeprl_tpu_torch.algos.ppo.agent import build_agent as build_ppo_agent

A2CAgent = PPOAgent


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                agent_state: Optional[Dict[str, Any]] = None, device: torch.device | str = "cpu") -> A2CAgent:
    """PPO's :func:`~sheeprl_tpu_torch.algos.ppo.agent.build_agent`; raises
    on pixel keys, as the JAX package's does."""
    if cfg.algo.cnn_keys.encoder:
        raise ValueError("A2C only supports vector observations (algo.cnn_keys.encoder must be [])")
    return build_ppo_agent(actions_dim, is_continuous, cfg, obs_space, agent_state, device)
