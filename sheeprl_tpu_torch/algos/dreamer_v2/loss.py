"""DreamerV2's world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v2/loss.py``): ``Normal(., 1)`` observation and
reward log-probs, alpha-form KL balancing with free nats on the batch mean
(``kl_free_avg``) or per element, and the continue head's Bernoulli scaled
by ``discount_scale_factor``."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.ops.distributions import Bernoulli, kl_categorical


def normal_log_prob(mean: torch.Tensor, value: torch.Tensor, event_dims: int) -> torch.Tensor:
    """``Independent(Normal(mean, 1))``'s log-prob, summed over the
    trailing ``event_dims``, in fp32 whatever the inputs' dtype."""
    lp = -0.5 * (value.float() - mean.float()) ** 2 - 0.5 * math.log(2 * math.pi)
    return lp.sum(dim=tuple(range(-event_dims, 0)))


def reconstruction_loss(
    recon: Dict[str, torch.Tensor],
    observations: Dict[str, torch.Tensor],
    reward_mean: torch.Tensor,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 1.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc: Optional[Bernoulli] = None,
    continue_targets: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """``(total, kl, kl_loss, reward_loss, observation_loss,
    continue_loss)``; ``priors_logits``/``posteriors_logits`` are ``[T, B,
    stoch, discrete]``."""
    observation_loss = -sum(
        torch.mean(normal_log_prob(recon[k], observations[k], recon[k].dim() - 2)) for k in recon)
    reward_loss = -torch.mean(normal_log_prob(reward_mean, rewards, 1))
    lhs = kl = kl_categorical(posteriors_logits.detach(), priors_logits, event_dims=1)
    rhs = kl_categorical(posteriors_logits, priors_logits.detach(), event_dims=1)
    if kl_free_avg:
        loss_lhs = torch.clamp(lhs.mean(), min=kl_free_nats)
        loss_rhs = torch.clamp(rhs.mean(), min=kl_free_nats)
    else:
        loss_lhs = torch.clamp(lhs, min=kl_free_nats).mean()
        loss_rhs = torch.clamp(rhs, min=kl_free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if pc is not None and continue_targets is not None:
        continue_loss = discount_scale_factor * -torch.mean(pc.log_prob(continue_targets))
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return total, kl.mean(), kl_loss, reward_loss, observation_loss, continue_loss
