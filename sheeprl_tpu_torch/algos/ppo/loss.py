"""PPO losses (counterpart of ``sheeprl_tpu/algos/ppo/loss.py``)."""

from __future__ import annotations

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"Unrecognized reduction: {reduction}")


def policy_loss(new_logprobs: torch.Tensor, old_logprobs: torch.Tensor, advantages: torch.Tensor,
                clip_coef: float | torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """The clipped surrogate objective, negated."""
    ratio = torch.exp(new_logprobs - old_logprobs)
    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef)
    return _reduce(torch.maximum(pg_loss1, pg_loss2), reduction)


def value_loss(new_values: torch.Tensor, old_values: torch.Tensor, returns: torch.Tensor,
               clip_coef: float | torch.Tensor, clip_vloss: bool, reduction: str = "mean") -> torch.Tensor:
    """Half the squared error to the returns, with ``clip_vloss`` the larger
    of it and that of the value clipped around the rollout's."""
    if not clip_vloss:
        return _reduce(0.5 * (new_values - returns) ** 2, reduction)
    v_loss_unclipped = (new_values - returns) ** 2
    v_clipped = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    v_loss_clipped = (v_clipped - returns) ** 2
    return _reduce(0.5 * torch.maximum(v_loss_unclipped, v_loss_clipped), reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """The entropy bonus, negated."""
    return _reduce(-entropy, reduction)
