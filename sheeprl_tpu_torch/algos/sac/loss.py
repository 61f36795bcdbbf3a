"""SAC losses (counterpart of ``sheeprl_tpu/algos/sac/loss.py``).  The
offline mode's conservative Q penalty is not ported yet (ROADMAP.md
Queue 1)."""

from __future__ import annotations

import torch


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor) -> torch.Tensor:
    """The sum over the critics (the last axis) of each one's MSE against
    the shared soft target."""
    return ((qf_values - next_qf_value) ** 2).mean(dim=tuple(range(qf_values.dim() - 1))).sum()


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, min_qf_values: torch.Tensor) -> torch.Tensor:
    """``mean(alpha * log_pi - Q)``."""
    return (alpha * logprobs - min_qf_values).mean()


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    """The entropy coefficient's loss, the log-probs held constant."""
    return (-log_alpha * (logprobs.detach() + target_entropy)).mean()
