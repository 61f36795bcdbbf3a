"""Recurrent PPO helpers (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/utils.py``): the metric keys, the
observations with a leading sequence axis of one, and the greedy test
episode carrying the LSTM state."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}
MODELS_TO_REGISTER = {"agent"}


def prepare_obs(stager, obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (),
                num_envs: int = 1) -> Dict[str, torch.Tensor]:
    """Host observations -> ``[1, N, ...]`` device tensors in one copy
    (pixels raw uint8, the agent scales them)."""
    from sheeprl_tpu_torch.envs.player import host_obs_slab

    return {k: v[None] for k, v in stager(host_obs_slab(obs, cnn_keys, mlp_keys, num_envs)).items()}


@torch.no_grad()
def test(agent, env, cfg, device: torch.device | str, stager=None) -> float:
    """One greedy episode of ``env`` (closed after) carrying the LSTM state
    and the previous action; returns the cumulative reward.  ``dry_run``
    stops after one step."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import prev_actions_of
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.player import ObsStager
    from sheeprl_tpu_torch.parallel.precision import call_cast

    stager = stager or ObsStager(device)
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    hidden = int(cfg.algo.rnn.lstm.hidden_size)
    hx = cx = torch.zeros((1, hidden), device=device)
    prev_actions = torch.zeros((1, 1, sum(agent.actions_dim)), device=device)
    done, cumulative_rew = False, 0.0
    obs, _ = env.reset(seed=cfg.seed)
    while not done:
        actions, _, _, _, (hx, cx) = call_cast((agent,), torch.float32, lambda: agent(
            prepare_obs(stager, obs, cnn_keys, mlp_keys), prev_actions, hx, cx, greedy=True))
        prev_actions = prev_actions_of(actions, agent.actions_dim, agent.is_continuous)
        actions_np = actions.cpu().numpy()
        if isinstance(env.action_space, spaces.Discrete):
            env_actions = int(actions_np[0, 0, 0])
        elif isinstance(env.action_space, spaces.MultiDiscrete):
            env_actions = actions_np[0, 0].astype(np.int64)
        else:
            env_actions = actions_np.reshape(env.action_space.shape)
        obs, reward, terminated, truncated, _ = env.step(env_actions)
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.dry_run:
            done = True
    env.close()
    return cumulative_rew
