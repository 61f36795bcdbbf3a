"""DreamerV1's losses (counterpart of ``sheeprl_tpu/algos/dreamer_v1/loss.py``):
``Normal(., 1)`` observation and reward log-probs, the Gaussian KL with free
nats on its mean, and the continue head's Bernoulli with the JAX package's
sign (ROADMAP.md Queue 3)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.loss import normal_log_prob
from sheeprl_tpu_torch.ops.distributions import Bernoulli


def kl_normal(p_mean, p_std, q_mean, q_std, event_dims: int = 1) -> torch.Tensor:
    """``KL(N(p) || N(q))`` summed over the trailing ``event_dims``, in fp32."""
    p_mean, p_std, q_mean, q_std = p_mean.float(), p_std.float(), q_mean.float(), q_std.float()
    var_ratio = (p_std / q_std) ** 2
    t1 = ((p_mean - q_mean) / q_std) ** 2
    kl = 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    return kl.sum(dim=tuple(range(-event_dims, 0)))


def reconstruction_loss(
    recon: Dict[str, torch.Tensor],
    observations: Dict[str, torch.Tensor],
    reward_mean: torch.Tensor,
    rewards: torch.Tensor,
    posterior_mean_std: Tuple[torch.Tensor, torch.Tensor],
    prior_mean_std: Tuple[torch.Tensor, torch.Tensor],
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc: Optional[Bernoulli] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, ...]:
    """``(total, kl, state_loss, reward_loss, observation_loss,
    continue_loss)``."""
    observation_loss = -sum(
        torch.mean(normal_log_prob(recon[k], observations[k], recon[k].dim() - 2)) for k in recon)
    reward_loss = -torch.mean(normal_log_prob(reward_mean, rewards, 1))
    kl = torch.mean(kl_normal(posterior_mean_std[0], posterior_mean_std[1], prior_mean_std[0], prior_mean_std[1]))
    state_loss = torch.clamp(kl, min=kl_free_nats)
    if qc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -torch.mean(qc.log_prob(continue_targets))
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return total, kl, state_loss, reward_loss, observation_loss, continue_loss
