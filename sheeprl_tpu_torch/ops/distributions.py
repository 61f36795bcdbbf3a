"""The distributions of the DreamerV3 losses and actor heads and of the PPO
actor (counterpart of ``sheeprl_tpu/ops/distributions.py``): light classes
over tensors.  ``log_prob``/``mean``/``entropy`` and the KL compute in fp32
at the loss boundary, as the JAX package's do, whatever dtype the network
ran in.  Sampling takes pre-drawn noise (a standard-normal draw, a uniform
one for the truncated normal, or Gumbel noise for a categorical), so a test
can feed the draws of the JAX package's keys."""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.numerics import safeatanh, safetanh, symexp, symlog


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


class Normal:
    """Diagonal normal; ``log_prob``/``entropy`` sum the last
    ``event_dims`` axes."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, event_dims: int = 0):
        self.loc = loc
        self.scale = scale
        self.event_dims = event_dims

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    def rsample(self, noise: torch.Tensor) -> torch.Tensor:
        """``loc + scale * noise``, ``noise`` a standard-normal draw."""
        return self.loc + self.scale * noise.to(self.loc.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        loc, scale, value = _f32(self.loc), _f32(self.scale), _f32(value)
        lp = -((value - loc) ** 2) / (2 * scale**2) - torch.log(scale) - 0.5 * math.log(2 * math.pi)
        return _sum_last_dims(lp, self.event_dims)

    def entropy(self) -> torch.Tensor:
        ent = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(_f32(self.scale))
        return _sum_last_dims(ent, self.event_dims)


class TanhNormal:
    """A normal squashed by tanh, with the numerically safe tanh/atanh
    (``eps`` from the bounds) in the change of variables."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, event_dims: int = 1, eps: float = 1e-6):
        self.base = Normal(loc, scale, event_dims=0)
        self.event_dims = event_dims
        self.eps = eps

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(self.base.loc)

    mode = mean

    def rsample(self, noise: torch.Tensor) -> torch.Tensor:
        return safetanh(self.base.rsample(noise), self.eps)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        value = _f32(value)
        x = safeatanh(value, self.eps)
        lp = self.base.log_prob(x) - torch.log1p(-(value**2) + self.eps)
        return _sum_last_dims(lp, self.event_dims)


def _phi(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x**2) / math.sqrt(2 * math.pi)


class TruncatedNormal:
    """A normal truncated to ``[a, b]``, sampled by inverting its CDF, so
    that gradients reach ``loc`` and ``scale`` (DreamerV2's continuous
    actor).  ``log_prob`` and ``entropy`` sum the last ``event_dims`` axes."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, a: float = -1.0, b: float = 1.0, event_dims: int = 1):
        self.loc = loc
        self.scale = scale
        self.a = a
        self.b = b
        self.event_dims = event_dims
        self._alpha = (a - loc) / scale
        self._beta = (b - loc) / scale

    @staticmethod
    def _big_phi(x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (1 + torch.special.erf(x / math.sqrt(2)))

    @property
    def _Z(self) -> torch.Tensor:
        return torch.clamp(self._big_phi(self._beta) - self._big_phi(self._alpha), min=1e-8)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc + self.scale * (_phi(self._alpha) - _phi(self._beta)) / self._Z

    @property
    def mode(self) -> torch.Tensor:
        return torch.clamp(self.loc, self.a, self.b)

    def rsample(self, uniform: torch.Tensor) -> torch.Tensor:
        """The draw at ``uniform``, a uniform draw in ``[1e-6, 1 - 1e-6]``,
        clamped into the open support."""
        u = self._big_phi(self._alpha) + uniform.to(self.loc.dtype) * self._Z
        out = self.loc + self.scale * math.sqrt(2) * torch.special.erfinv(2 * u - 1)
        return torch.clamp(out, self.a + 1e-6, self.b - 1e-6)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        loc, scale, value = _f32(self.loc), _f32(self.scale), _f32(value)
        z = (value - loc) / scale
        lp = -0.5 * z**2 - 0.5 * math.log(2 * math.pi) - torch.log(scale) - torch.log(_f32(self._Z))
        return _sum_last_dims(lp, self.event_dims)

    def entropy(self) -> torch.Tensor:
        Z = self._Z
        term = (self._alpha * _phi(self._alpha) - self._beta * _phi(self._beta)) / (2 * Z)
        ent = 0.5 * math.log(2 * math.pi * math.e) + torch.log(self.scale * Z) + term
        return _sum_last_dims(ent, self.event_dims)


class Categorical:
    """Categorical over the last axis of ``logits`` (normalized in fp32)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = torch.log_softmax(_f32(logits), dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return self.logits.argmax(dim=-1)

    def sample(self, gumbel: torch.Tensor) -> torch.Tensor:
        """The Gumbel-max draw: ``argmax(logits + gumbel)``, as
        ``jax.random.categorical`` draws."""
        return (self.logits + gumbel.to(self.logits.dtype)).argmax(dim=-1)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """The log-probability of each class index; NaN for an index out of
        range (a poisoned batch's NaN actions), as ``take_along_axis`` fills
        in JAX, where a gather would fault."""
        n = self.logits.shape[-1]
        idx = value.long()
        inside = (idx >= 0) & (idx < n)
        lp = self.logits.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, lp, torch.full_like(lp, float("nan")))

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(dim=-1)


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
