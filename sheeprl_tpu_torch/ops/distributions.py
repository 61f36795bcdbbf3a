"""The distributions of the DreamerV3 losses (counterpart of
``sheeprl_tpu/ops/distributions.py``): light classes over tensors.
``log_prob``/``mean`` and the KL compute in fp32 at the loss boundary, as the
JAX package's do, whatever dtype the network ran in."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.numerics import symexp, symlog


def _sum_last_dims(x: torch.Tensor, dims: int) -> torch.Tensor:
    if dims == 0:
        return x
    return x.sum(dim=tuple(range(-dims, 0)))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.is_floating_point() else x


def kl_categorical(p_logits: torch.Tensor, q_logits: torch.Tensor, event_dims: int = 0) -> torch.Tensor:
    """KL(p || q) between categoricals over the last axis, summed over
    ``event_dims`` trailing batch dims (the KL balancing of DreamerV3)."""
    p_logits = torch.log_softmax(_f32(p_logits), dim=-1)
    q_logits = torch.log_softmax(_f32(q_logits), dim=-1)
    kl = (p_logits.exp() * (p_logits - q_logits)).sum(dim=-1)
    return _sum_last_dims(kl, event_dims)


class Bernoulli:
    """Bernoulli with a defined mode (the continue head)."""

    def __init__(self, logits: torch.Tensor, event_dims: int = 0):
        self.logits = logits
        self.event_dims = event_dims

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        # -softplus(-l) for value 1, -softplus(l) for value 0
        logits, value = _f32(self.logits), _f32(value)
        lp = -F.softplus(-logits) * value - F.softplus(logits) * (1 - value)
        return _sum_last_dims(lp, self.event_dims)


class SymlogDistribution:
    """Symlog-MSE pseudo-distribution of a vector reconstruction."""

    def __init__(self, mode: torch.Tensor, dims: int, dist: str = "mse", agg: str = "sum", tol: float = 1e-8):
        self._mode = mode
        self._dims = dims
        self._dist = dist
        self._agg = agg
        self._tol = tol

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        if self._mode.shape != value.shape:
            raise ValueError(f"mode {tuple(self._mode.shape)} and value {tuple(value.shape)} differ in shape")
        mode, value = _f32(self._mode), _f32(value)
        if self._dist == "mse":
            distance = (mode - symlog(value)) ** 2
        elif self._dist == "abs":
            distance = (mode - symlog(value)).abs()
        else:
            raise NotImplementedError(self._dist)
        distance = torch.where(distance < self._tol, torch.zeros_like(distance), distance)
        axes = tuple(range(-self._dims, 0))
        return -(distance.mean(dim=axes) if self._agg == "mean" else distance.sum(dim=axes))


class MSEDistribution:
    """Plain MSE pseudo-distribution (the image decoder)."""

    def __init__(self, mode: torch.Tensor, dims: int, agg: str = "sum"):
        self._mode = mode
        self._dims = dims
        self._agg = agg

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        if self._mode.shape != value.shape:
            raise ValueError(f"mode {tuple(self._mode.shape)} and value {tuple(value.shape)} differ in shape")
        distance = (_f32(self._mode) - _f32(value)) ** 2
        axes = tuple(range(-self._dims, 0))
        return -(distance.mean(dim=axes) if self._agg == "mean" else distance.sum(dim=axes))


class TwoHotEncodingDistribution:
    """Two-hot symlog distribution over scalars on ``logits.shape[-1]`` bins
    (the reward head and the critic)."""

    def __init__(
        self,
        logits: torch.Tensor,
        dims: int = 0,
        low: int = -20,
        high: int = 20,
        transfwd: Callable[[torch.Tensor], torch.Tensor] = symlog,
        transbwd: Callable[[torch.Tensor], torch.Tensor] = symexp,
    ):
        self.logits = _f32(logits)
        self.dims = dims
        self.transfwd = transfwd
        self.transbwd = transbwd
        self.bins = torch.linspace(low, high, logits.shape[-1], dtype=self.logits.dtype, device=logits.device)
        # the bins axis replaces the scalar (..., 1) event axis
        self._reduce_axes = tuple(range(-max(dims, 1), 0))

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return self.transbwd((self.probs * self.bins).sum(dim=self._reduce_axes, keepdim=True))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transfwd(_f32(x))
        nbins = self.bins.shape[0]
        below = (self.bins <= x).to(torch.int64).sum(dim=-1, keepdim=True) - 1
        above = (below + 1).clamp(0, nbins - 1)
        below = below.clamp(0, nbins - 1)
        equal = below == above
        one = torch.ones_like(x)
        dist_to_below = torch.where(equal, one, (self.bins[below] - x).abs())
        dist_to_above = torch.where(equal, one, (self.bins[above] - x).abs())
        total = dist_to_below + dist_to_above
        weight_below = dist_to_above / total
        weight_above = dist_to_below / total
        target = (
            F.one_hot(below, nbins).to(self.logits.dtype) * weight_below[..., None]
            + F.one_hot(above, nbins).to(self.logits.dtype) * weight_above[..., None]
        )[..., 0, :]
        log_pred = torch.log_softmax(self.logits, dim=-1)
        return (target * log_pred).sum(dim=self._reduce_axes)
