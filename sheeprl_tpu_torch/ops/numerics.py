"""Numerics shared across algorithms (counterpart of
``sheeprl_tpu/ops/numerics.py``): symlog/symexp, the two-hot code, the
uniform mix and the TD(lambda) returns of DreamerV3."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


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
