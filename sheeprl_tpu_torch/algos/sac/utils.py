"""SAC helpers (counterpart of ``sheeprl_tpu/algos/sac/utils.py``): the
metric keys, the flat observation the networks read and the test episode."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
    "Grads/global_norm",
}
MODELS_TO_REGISTER = {"agent"}


def prepare_obs(obs: Dict[str, np.ndarray], stager, mlp_keys: Sequence[str] = (), num_envs: int = 1) -> torch.Tensor:
    """The vector keys concatenated into ``[num_envs, D]`` float32, staged
    on the device in one host-to-device copy (``stager``, an
    ``envs/player.py::ObsStager``)."""
    flat = np.concatenate([np.asarray(obs[k], dtype=np.float32).reshape(num_envs, -1) for k in mlp_keys], axis=-1)
    return stager({"observations": flat})["observations"]


@torch.no_grad()
def test(actor, env, cfg, device: torch.device | str, stager=None) -> float:
    """One greedy episode of ``env`` (closed after): the squashed mean of
    ``actor``; returns the cumulative reward.  ``dry_run`` stops after one
    step."""
    from sheeprl_tpu_torch.envs.player import ObsStager, fetch_values

    stager = stager or ObsStager(device)
    done, cumulative_rew = False, 0.0
    obs, _ = env.reset(seed=cfg.seed)
    while not done:
        (action,) = fetch_values(actor.greedy_action(prepare_obs(obs, stager, cfg.algo.mlp_keys.encoder)))
        obs, reward, terminated, truncated, _ = env.step(action.reshape(env.action_space.shape))
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.dry_run:
            done = True
    env.close()
    return cumulative_rew
