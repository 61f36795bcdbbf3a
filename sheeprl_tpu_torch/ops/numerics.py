"""Numerics shared across algorithms (counterpart of
``sheeprl_tpu/ops/numerics.py``; the serving slice needs symlog/symexp)."""

from __future__ import annotations

import torch


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)
