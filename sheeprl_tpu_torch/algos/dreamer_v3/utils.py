"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``):
the dynamic-learning scan, the Moments percentile EMA, the observation
staging of the player and the test episode."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic", "moments"}


def chunked_dynamic_scan(
    world_model,
    batch_actions: torch.Tensor,
    embedded: torch.Tensor,
    is_first: torch.Tensor,
    *,
    stoch_flat: int,
    recurrent_size: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The T-step dynamic-learning scan from a zero state, one
    ``world_model.dynamic`` step per row of ``[T, B, ...]``: the JAX
    package's sequential scan (``algo.rssm_chunks=1``; the chunked
    stored-state scan is not ported).  ``noise`` is ``(prior, posterior)``
    Gumbel noise, each ``[T, B, stoch, discrete]``.  Returns the stacked
    ``(recurrents, posteriors, posterior_logits, prior_logits)``."""
    T, B = batch_actions.shape[:2]
    posterior = torch.zeros((B, stoch_flat), dtype=embedded.dtype, device=embedded.device)
    recurrent = torch.zeros((B, recurrent_size), dtype=embedded.dtype, device=embedded.device)
    outs = []
    for t in range(T):
        step_noise = None if noise is None else (noise[0][t], noise[1][t])
        recurrent, posterior, _, post_logits, prior_logits = world_model.dynamic(
            posterior, recurrent, batch_actions[t], embedded[t], is_first[t], generator, step_noise
        )
        outs.append((recurrent, posterior, post_logits, prior_logits))
    return tuple(torch.stack(x) for x in zip(*outs))


def init_moments_state(device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    return {"low": torch.zeros((), device=device), "high": torch.zeros((), device=device)}


def update_moments(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1.0,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """``(offset, invscale, new_state)``: an EMA of the return percentiles
    (both packages' quantiles interpolate linearly)."""
    x = x.detach().float().reshape(-1)
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state["low"] + (1 - decay) * low
    new_high = decay * state["high"] + (1 - decay) * high
    invscale = torch.clamp(new_high - new_low, min=1.0 / max_)
    return new_low, invscale, {"low": new_low, "high": new_high}


def prepare_obs(
    obs: Dict[str, np.ndarray],
    *,
    cnn_keys: Sequence[str] = (),
    mlp_keys: Sequence[str] = (),
    num_envs: int = 1,
    device: torch.device | str = "cpu",
) -> Dict[str, torch.Tensor]:
    """Host observations -> device tensors ``[num_envs, ...]``: pixels cross
    as uint8 and are scaled to [-0.5, 0.5] on the device."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        v = np.asarray(obs[k])
        v = torch.from_numpy(np.ascontiguousarray(v.reshape(num_envs, -1, *v.shape[-2:]))).to(device)
        out[k] = v.float() / 255.0 - 0.5
    for k in mlp_keys:
        out[k] = torch.from_numpy(np.asarray(obs[k], np.float32).reshape(num_envs, -1)).to(device)
    return out


def real_actions_of(actions: np.ndarray, actions_dim: Sequence[int], is_continuous: bool) -> np.ndarray:
    """The env's actions from the actor's output: the vector itself for a
    continuous head, the argmax of each one-hot block otherwise."""
    if is_continuous:
        return actions
    idxs, start = [], 0
    for d in actions_dim:
        idxs.append(np.argmax(actions[..., start : start + d], axis=-1))
        start += d
    return np.stack(idxs, axis=-1)


def test(player, cfg, log_dir: Optional[str], generator: torch.Generator, greedy: bool = True) -> Tuple[float, int]:
    """One test episode with a one-env player; returns the cumulative reward
    and the number of policy steps it took."""
    from sheeprl_tpu_torch.envs.env import make_env

    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    done = False
    cumulative_rew, steps = 0.0, 0
    obs = env.reset(seed=cfg.seed)[0]
    saved_num_envs = player.num_envs
    player.num_envs = 1
    player.state = None
    player.init_states()
    device = player.world_model.rssm.initial_recurrent_state.device
    try:
        while not done:
            torch_obs = prepare_obs(obs, cnn_keys=cfg.algo.cnn_keys.encoder, mlp_keys=cfg.algo.mlp_keys.encoder,
                                    device=device)
            actions = player.get_actions(torch_obs, generator, greedy=greedy).cpu().numpy()
            real_actions = real_actions_of(actions, player.actions_dim, player.actor.is_continuous)
            obs, reward, terminated, truncated, _ = env.step(real_actions.reshape(env.action_space.shape))
            done = bool(terminated or truncated or cfg.dry_run)
            cumulative_rew += float(reward)
            steps += 1
    finally:
        env.close()
        player.num_envs = saved_num_envs
        player.state = None
    return cumulative_rew, steps
