"""DreamerV3 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v3/loss.py``): observation, reward and continue
log-probs and the balanced KL with free nats."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.ops.distributions import Bernoulli, TwoHotEncodingDistribution, kl_categorical


def reconstruction_loss(
    po: Dict[str, object],
    observations: Dict[str, torch.Tensor],
    pr: TwoHotEncodingDistribution,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc: Optional[Bernoulli] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """Priors/posteriors logits are ``[T, B, stoch, discrete]``.  Returns
    ``(loss, kl, kl_loss, reward_loss, observation_loss, continue_loss)``,
    each a mean over ``[T, B]``."""
    if len(po) == 0:
        observation_loss = torch.zeros_like(rewards[..., 0])
    else:
        observation_loss = -sum(po[k].log_prob(observations[k]) for k in po.keys())
    reward_loss = -pr.log_prob(rewards)
    # KL balancing: the dynamics term trains the prior, the representation
    # term the posterior, each against the other held fixed
    dyn_loss = kl = kl_categorical(posteriors_logits.detach(), priors_logits, event_dims=1)
    free_nats = torch.full_like(dyn_loss, kl_free_nats)
    dyn_loss = kl_dynamic * torch.maximum(dyn_loss, free_nats)
    repr_loss = kl_categorical(posteriors_logits, priors_logits.detach(), event_dims=1)
    repr_loss = kl_representation * torch.maximum(repr_loss, free_nats)
    kl_loss = dyn_loss + repr_loss
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return rec_loss, kl.mean(), kl_loss.mean(), reward_loss.mean(), observation_loss.mean(), continue_loss.mean()
