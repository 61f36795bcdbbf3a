"""Numerics shared across algorithms (counterpart of
``sheeprl_tpu/ops/numerics.py``): symlog/symexp, the safe tanh/atanh, the
two-hot code, the uniform mix, the TD(lambda) returns of DreamerV3 and the
generalized advantage estimate of PPO."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def safetanh(x: torch.Tensor, eps: float) -> torch.Tensor:
    lim = 1.0 - eps
    return torch.clamp(torch.tanh(x), -lim, lim)


def safeatanh(y: torch.Tensor, eps: float) -> torch.Tensor:
    lim = 1.0 - eps
    return torch.atanh(torch.clamp(y, -lim, lim))


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Two-hot code of a ``[..., 1]`` tensor on the odd-sized linear support
    ``[-support_range, support_range]``; ties map to the left bucket."""
    if num_buckets is None:
        num_buckets = support_range * 2 + 1
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    x = x.clamp(-support_range, support_range)
    buckets = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    bucket_size = buckets[1] - buckets[0] if num_buckets > 1 else torch.ones((), dtype=x.dtype, device=x.device)
    # x is clipped to the support, so the right index is a bucket
    right_idxs = torch.searchsorted(buckets, x.contiguous(), side="left")
    left_idxs = (right_idxs - 1).clamp(0, num_buckets - 1)
    left_value = (buckets[right_idxs] - x).abs() / bucket_size
    right_value = 1.0 - left_value
    left_oh = F.one_hot(left_idxs[..., 0], num_buckets).to(x.dtype)
    right_oh = F.one_hot(right_idxs[..., 0], num_buckets).to(x.dtype)
    return left_oh * left_value + right_oh * right_value


def two_hot_decoder(x: torch.Tensor, support_range: int) -> torch.Tensor:
    """The scalar a two-hot vector encodes."""
    num_buckets = x.shape[-1]
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    support = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    return (x * support).sum(dim=-1, keepdim=True)


def uniform_mix(logits: torch.Tensor, unimix: float = 0.01) -> torch.Tensor:
    """Mix ``unimix`` uniform probability into categorical logits over the
    last axis (DreamerV3's 1 % unimix)."""
    if unimix <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    probs = (1.0 - unimix) * probs + unimix * (torch.ones_like(probs) / probs.shape[-1])
    return torch.log(probs)


def compute_lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """TD(lambda) returns of imagined trajectories ``[H, ...]``, the JAX
    package's reverse scan as a loop from the last step back."""
    interm = rewards + continues * values * (1 - lmbda)
    nxt = values[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nxt = interm[t] + continues[t] * lmbda * nxt
        out.append(nxt)
    return torch.stack(out[::-1])


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over the leading time axis
    ``[T, ...]``; returns ``(returns, advantages)``.

    As the JAX package's ``gae``: step ``t`` bootstraps from ``values[t+1]``
    masked by ``1 - dones[t]``, and the last step from ``next_value`` masked
    by ``1 - dones[-1]``; the same mask carries the running advantage back."""
    not_dones = 1.0 - dones.to(values.dtype)
    rewards = rewards.to(values.dtype)
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    next_nonterminal = torch.cat([not_dones[:-1], not_dones[-1:]], dim=0)
    deltas = rewards + gamma * next_values * next_nonterminal - values
    lastgaelam = torch.zeros_like(deltas[0])
    advantages = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        lastgaelam = deltas[t] + gamma * gae_lambda * next_nonterminal[t] * lastgaelam
        advantages.append(lastgaelam)
    advantages = torch.stack(advantages[::-1])
    return advantages + values, advantages
