"""SAC-AE helpers (counterpart of ``sheeprl_tpu/algos/sac_ae/utils.py``):
the metric keys, the reconstruction target, the observations the networks
read and the test episode."""

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
    "Loss/reconstruction_loss",
}
MODELS_TO_REGISTER = {"agent", "encoder", "decoder"}


def preprocess_obs(obs: torch.Tensor, noise: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Bit reduction and dequantization noise (https://arxiv.org/abs/1807.03039)
    of pixels in ``[0, 255]``; ``noise`` is the pre-drawn uniform ``[0, 1)``
    of ``obs``'s shape."""
    bins = 2**bits
    if bits < 8:
        obs = torch.floor(obs / 2 ** (8 - bits))
    obs = obs / bins
    obs = obs + noise / bins
    return obs - 0.5


def prepare_obs(obs: Dict[str, np.ndarray], stager, cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (),
                num_envs: int = 1) -> Dict[str, torch.Tensor]:
    """The networks' observations from the envs', staged in one
    host-to-device copy: pixels as ``[N, C, H, W]`` floats in ``[0, 1]`` (a
    frame stack's frames folded into the channels; scaled on the device),
    vector keys as float32 ``[N, D]``."""
    from sheeprl_tpu_torch.envs.player import host_obs_slab

    staged = stager(host_obs_slab(obs, cnn_keys, mlp_keys, num_envs))
    return {k: v.float() / 255.0 if k in cnn_keys else v for k, v in staged.items()}


@torch.no_grad()
def test(agent, env, cfg, device: torch.device | str, stager=None) -> float:
    """One greedy episode of ``env`` (closed after); returns the
    cumulative reward.  ``dry_run`` stops after one step."""
    from sheeprl_tpu_torch.envs.player import ObsStager, fetch_values

    stager = stager or ObsStager(device)
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    done, cumulative_rew = False, 0.0
    obs, _ = env.reset(seed=cfg.seed)
    while not done:
        features = agent.encoder(prepare_obs(obs, stager, cnn_keys, mlp_keys))
        (action,) = fetch_values(agent.actor.greedy_action(features))
        obs, reward, terminated, truncated, _ = env.step(action.reshape(env.action_space.shape))
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.dry_run:
            done = True
    env.close()
    return cumulative_rew
