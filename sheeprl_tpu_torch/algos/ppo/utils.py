"""PPO helpers (counterpart of ``sheeprl_tpu/algos/ppo/utils.py``): the
metric keys, the env actions of the agent's output and the test episode."""

from __future__ import annotations

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
    "Grads/global_norm",
}
MODELS_TO_REGISTER = {"agent"}


def env_actions_of(actions: np.ndarray, is_continuous: bool, is_multidiscrete: bool, num_envs: int) -> np.ndarray:
    """The vector env's actions from the agent's ``[N, A]`` output."""
    if is_continuous:
        return actions.reshape(num_envs, -1)
    if is_multidiscrete:
        return actions.astype(np.int64)
    return actions[:, 0].astype(np.int64)


@torch.no_grad()
def test(agent, env, cfg, device: torch.device | str, stager=None) -> float:
    """One greedy episode of ``env`` (closed after); returns the
    cumulative reward.  ``dry_run`` stops after one step."""
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.player import ObsStager, fetch_values, host_obs_slab

    stager = stager or ObsStager(device)
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    done, cumulative_rew = False, 0.0
    obs, _ = env.reset(seed=cfg.seed)
    while not done:
        actions, _, _, _ = agent(stager(host_obs_slab(obs, cnn_keys, mlp_keys)), greedy=True)
        (actions,) = fetch_values(actions)
        if isinstance(env.action_space, spaces.Discrete):
            env_actions = int(actions[0, 0])
        elif isinstance(env.action_space, spaces.MultiDiscrete):
            env_actions = actions[0].astype(np.int64)
        else:
            env_actions = actions.reshape(env.action_space.shape)
        obs, reward, terminated, truncated, _ = env.step(env_actions)
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.dry_run:
            done = True
    env.close()
    return cumulative_rew
