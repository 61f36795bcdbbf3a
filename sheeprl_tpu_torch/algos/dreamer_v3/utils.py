"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``):
the dynamic-learning scan, sequential or chunked over replay-stored states,
the Moments percentile EMA, the observation staging of the player and the
test episode."""

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


#: replay keys holding the player's post-step RSSM state when
#: ``algo.rssm_chunks > 1`` (stored-state chunking, as in SEED-RL and R2D2):
#: ``rssm_recurrent``/``rssm_posterior`` are the state after the row's
#: observation, ``rssm_valid`` is 1 only on rows the player wrote (prefill
#: and episode-end bookkeeping rows hold zeros and 0: a chunk starting there
#: resets to the learned initial state)
RSSM_STATE_KEYS = ("rssm_recurrent", "rssm_posterior", "rssm_valid")


def rssm_scan_spec(cfg) -> Tuple[int, int]:
    """``(chunks, burn_in)`` from ``algo.rssm_chunks`` /
    ``algo.rssm_chunk_burn_in``; ``(1, 0)`` without them."""
    chunks = int(cfg.algo.get("rssm_chunks", 1) or 1)
    burn_in = int(cfg.algo.get("rssm_chunk_burn_in", 0) or 0)
    if chunks < 1:
        raise ValueError(f"algo.rssm_chunks must be >= 1, got {chunks}")
    if burn_in < 0:
        raise ValueError(f"algo.rssm_chunk_burn_in must be >= 0, got {burn_in}")
    return chunks, burn_in


def _scan(world_model, posterior, recurrent, actions, embedded, is_first, generator, noise):
    """One ``world_model.dynamic`` step per row of the ``[steps, rows, ...]``
    inputs; returns the stacked ``(recurrents, posteriors, posterior_logits,
    prior_logits)`` and the last ``(posterior, recurrent)``."""
    outs = []
    for t in range(actions.shape[0]):
        step_noise = None if noise is None else (noise[0][t], noise[1][t])
        recurrent, posterior, _, post_logits, prior_logits = world_model.dynamic(
            posterior, recurrent, actions[t], embedded[t], is_first[t], generator, step_noise
        )
        outs.append((recurrent, posterior, post_logits, prior_logits))
    return tuple(torch.stack(x) for x in zip(*outs)), (posterior, recurrent)


def chunked_dynamic_scan(
    world_model,
    batch_actions: torch.Tensor,
    embedded: torch.Tensor,
    is_first: torch.Tensor,
    *,
    stoch_flat: int,
    recurrent_size: int,
    chunks: int = 1,
    burn_in: int = 0,
    stored_recurrent: Optional[torch.Tensor] = None,
    stored_posterior: Optional[torch.Tensor] = None,
    stored_valid: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    burn_in_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The T-step dynamic-learning scan over ``[T, B, ...]`` inputs in the
    compute dtype of ``embedded``; returns the stacked ``(recurrents,
    posteriors, posterior_logits, prior_logits)`` in the ``[T, B, ...]``
    layout.

    * ``chunks == 1``: the sequential scan from a zero state.
    * ``chunks = K > 1``: the sequence splits into K chunks of ``C = T / K``
      rows, folded into the batch (row ``t = k*C + c`` -> step ``c``, row
      ``k*B + b``), so each GRU call runs at ``K*B`` rows for ``C`` steps.
      Chunk 0 starts from zeros; chunk k from the replay-stored state of row
      ``k*C - 1``, and where that state is invalid the chunk start is a
      reset (``is_first``), on a copy of ``is_first``.
    * ``burn_in > 0``: before the scan, the ``burn_in`` rows before each
      boundary are re-run from the state stored just before them, without
      gradient, at ``(K-1)*B`` rows; their last state starts chunks 1..K-1.

    No gradient reaches the stored states or the burn-in.  ``noise`` is
    ``(prior, posterior)`` Gumbel noise ``[T, B, stoch, discrete]`` in the
    unfolded layout; ``burn_in_noise`` the same ``[burn_in, (K-1)*B, stoch,
    discrete]`` for the burn-in steps.  Without them draws come from
    ``generator``.  The JAX package's ``chunked_dynamic_scan``, its errors
    included."""
    T, B = batch_actions.shape[:2]
    cdt, device = embedded.dtype, embedded.device
    if chunks <= 1:
        posterior = torch.zeros((B, stoch_flat), dtype=cdt, device=device)
        recurrent = torch.zeros((B, recurrent_size), dtype=cdt, device=device)
        return _scan(world_model, posterior, recurrent, batch_actions, embedded, is_first, generator, noise)[0]

    K = int(chunks)
    if T % K != 0:
        raise ValueError(f"algo.rssm_chunks ({K}) must divide the sequence length ({T})")
    C = T // K
    if not 0 <= burn_in < C:
        raise ValueError(f"algo.rssm_chunk_burn_in ({burn_in}) must be in [0, chunk_length) = [0, {C})")
    if stored_recurrent is None or stored_posterior is None:
        raise ValueError(
            "algo.rssm_chunks > 1 needs the replay-stored RSSM state keys ('rssm_recurrent', 'rssm_posterior') in "
            "the batch (the training loop stores them when the option is set; a replay collected without them "
            "cannot be chunk-trained)"
        )

    def fold(x):  # [T, B, ...] -> [C, K*B, ...]
        return x.reshape((K, C) + tuple(x.shape[1:])).transpose(0, 1).reshape((C, K * B) + tuple(x.shape[2:]))

    def unfold(y):  # [C, K*B, ...] -> [T, B, ...]
        return y.reshape((C, K, B) + tuple(y.shape[2:])).transpose(0, 1).reshape((T, B) + tuple(y.shape[2:]))

    stored_z = stored_posterior.detach().to(cdt)
    stored_h = stored_recurrent.detach().to(cdt)
    valid = (stored_valid.detach().to(cdt) if stored_valid is not None
             else torch.ones((T, B, 1), dtype=cdt, device=device))
    boundary_rows = torch.arange(1, K, device=device) * C  # the first row of chunks 1..K-1

    if burn_in > 0:
        burn_rows = boundary_rows[:, None] - burn_in + torch.arange(burn_in, device=device)[None, :]  # [K-1, burn_in]

        def gather_fold(x):  # rows [K-1, burn_in] of [T, B, ...] -> [burn_in, (K-1)*B, ...]
            return x[burn_rows].transpose(0, 1).reshape((burn_in, (K - 1) * B) + tuple(x.shape[2:]))

        init_rows = boundary_rows - burn_in - 1
        is_first_burn = gather_fold(is_first).clone()
        invalid = 1.0 - valid[init_rows].reshape((K - 1) * B, 1)
        is_first_burn[0] = torch.maximum(is_first_burn[0], invalid)
        with torch.no_grad():
            _, (z_fresh, h_fresh) = _scan(
                world_model, stored_z[init_rows].reshape((K - 1) * B, stoch_flat),
                stored_h[init_rows].reshape((K - 1) * B, recurrent_size), gather_fold(batch_actions),
                gather_fold(embedded), is_first_burn, generator, burn_in_noise,
            )
        z_rest = z_fresh.detach().reshape(K - 1, B, stoch_flat)
        h_rest = h_fresh.detach().reshape(K - 1, B, recurrent_size)
        is_first_main = is_first
    else:
        init_rows = boundary_rows - 1
        z_rest, h_rest = stored_z[init_rows], stored_h[init_rows]
        invalid = 1.0 - valid[init_rows]  # [K-1, B, 1]
        is_first_main = is_first.clone()
        is_first_main[boundary_rows] = torch.maximum(is_first[boundary_rows], invalid)

    z_init = torch.cat([torch.zeros((1, B, stoch_flat), dtype=cdt, device=device), z_rest]).reshape(K * B, stoch_flat)
    h_init = torch.cat([torch.zeros((1, B, recurrent_size), dtype=cdt, device=device), h_rest]).reshape(
        K * B, recurrent_size)
    folded_noise = None if noise is None else (fold(noise[0]), fold(noise[1]))
    ys, _ = _scan(world_model, z_init, h_init, fold(batch_actions), fold(embedded), fold(is_first_main), generator,
                  folded_noise)
    return tuple(unfold(y) for y in ys)


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


def prepare_obs(stager, obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                num_envs: int = 1) -> Dict[str, torch.Tensor]:
    """Host observations -> device tensors ``[num_envs, ...]`` in the one
    copy of ``stager`` (``envs/player.py::ObsStager``): pixels cross as
    uint8 and are scaled to [-0.5, 0.5] on the device."""
    from sheeprl_tpu_torch.envs.player import host_obs_slab

    staged = stager(host_obs_slab(obs, cnn_keys, mlp_keys, num_envs))
    return {k: v.float() / 255.0 - 0.5 if k in cnn_keys else v for k, v in staged.items()}


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


def test(player, cfg, log_dir: Optional[str], generator: torch.Generator, greedy: bool = True,
         test_name: str = "") -> Tuple[float, int]:
    """One test episode with a one-env player; returns the cumulative reward
    and the number of policy steps it took.  ``test_name`` suffixes the
    env's ``test`` prefix (P2E's ``zero-shot``), as in the JAX package."""
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.envs.player import ObsStager

    env = make_env(cfg, cfg.seed, 0, log_dir, "test" + (f"_{test_name}" if test_name else ""))()
    done = False
    cumulative_rew, steps = 0.0, 0
    obs = env.reset(seed=cfg.seed)[0]
    saved_num_envs = player.num_envs
    player.num_envs = 1
    player.state = None
    player.init_states()
    stager = ObsStager(next(player.world_model.parameters()).device)
    try:
        while not done:
            torch_obs = prepare_obs(stager, obs, cfg.algo.cnn_keys.encoder, cfg.algo.mlp_keys.encoder)
            mask = {k: v for k, v in torch_obs.items() if k.startswith("mask")} or None
            actions = player.get_actions(torch_obs, generator, greedy=greedy, mask=mask).cpu().numpy()
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
