"""Optimizers named by the configs (counterpart of the optax transforms the
JAX package instantiates), each with optax's keys and defaults, so a JAX
run's archived config still reads.

``configs/optim/adam.yaml`` targets :func:`adam`, ``adamw.yaml``
:func:`adamw`: at optax's defaults for ``eps_root`` (and adamw's
``mu_dtype``, ``nesterov`` and ``mask``) they are ``torch.optim.Adam`` /
``AdamW``, whose updates are optax's (``eps`` outside the square root;
AdamW takes ``p - lr * wd * p - lr * adam(p)`` from the old ``p``); with
any of them set, :class:`OptaxAdam`, optax's ``scale_by_adam`` (and
``add_decayed_weights``) written out.  ``rmsprop.yaml`` targets
:func:`rmsprop`, optax's update written out (:class:`RMSprop`): optax
puts ``eps`` inside the square root by default and follows the scaled
update with a momentum trace, where ``torch.optim.RMSprop`` puts ``eps``
outside and keeps no trace at ``momentum=0``.  ``sgd.yaml`` targets
:func:`sgd`, optax's ``trace`` then the rate (:class:`SGD`).  The written-out
optimizers make their state at construction, as optax's ``init`` does, so a
state a checkpoint holds loads before the first step and ``skip_update``
has a state to revert to; each keeps its update count as ``step``, as
Adam does, for a learning-rate schedule and the bias corrections (RMSprop
only with ``bias_correction``: optax's keeps no count otherwise).  Their
arithmetic follows optax's order of operations, over a group's parameters
at once (``torch._foreach_*``), and the update is added to the parameter as
optax's ``apply_updates`` adds it.  Gradient clipping is
optax's ``clip_by_global_norm``, written out: torch's ``clip_grad_norm_``
divides by ``norm + 1e-6`` and always rescales.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype adamw's ``mu_dtype`` names (``"bfloat16"``,
    ``"float32"``, ...; ``jnp.`` or ``numpy.`` prefixes allowed), or None."""
    if name is None:
        return None
    dtype = getattr(torch, str(name).rsplit(".", 1)[-1], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a dtype: {name!r}")
    return dtype


def _decayed(decay: float, moments: List[torch.Tensor], dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
    """``decay * moment`` for each moment as optax computes it on a moment
    stored in ``dtype`` (the product in that dtype; a state loaded as
    float32 holds its values)."""
    if dtype is None:
        return torch._foreach_mul(moments, decay)
    return [m.to(dtype) * torch.tensor(decay, dtype=dtype, device=m.device) for m in moments]


def _bias_corrections(decay: float, counts: List[torch.Tensor]) -> List[torch.Tensor]:
    """optax's ``1 - decay ** count`` for each count, in float32."""
    corrections = torch._foreach_pow(decay, counts)
    torch._foreach_neg_(corrections)
    torch._foreach_add_(corrections, 1.0)
    return corrections


class _Written(torch.optim.Optimizer):
    """An optax update written out over each group's parameters at once:
    ``init_state(p, group)`` makes a parameter's state at construction and
    ``update(params, grads, states, group)`` returns optax's updates
    (before the rate) and writes the new states in place; the step adds
    ``-lr`` times the updates, after ``after_rate``, to the parameters and
    counts."""

    def __init__(self, params: Iterable[torch.nn.Parameter], defaults: dict):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p].update(self.init_state(p, group))

    def init_state(self, p: torch.Tensor, group: dict) -> dict:
        return {"step": torch.zeros((), dtype=torch.float32)}

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], states: List[dict],
               group: dict) -> List[torch.Tensor]:
        raise NotImplementedError

    def after_rate(self, updates: List[torch.Tensor], states: List[dict], group: dict) -> List[torch.Tensor]:
        """The transforms optax chains after the rate (the identity here)."""
        return updates

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(f"{type(self).__name__}.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            updates = torch._foreach_mul(self.update(params, [p.grad for p in params], states, group), -group["lr"])
            torch._foreach_add_(params, self.after_rate(updates, states, group))
            steps = [state["step"] for state in states if "step" in state]
            if steps:
                torch._foreach_add_(steps, 1.0)


def _trace(momentum: float, updates: List[torch.Tensor], traces: List[torch.Tensor],
           nesterov: bool) -> List[torch.Tensor]:
    """optax's ``trace``: ``t = u + momentum * t`` in place, applied as the
    update, or ``u + momentum * t`` with ``nesterov``."""
    torch._foreach_mul_(traces, momentum)
    torch._foreach_add_(traces, updates)
    if nesterov:
        return torch._foreach_add(updates, torch._foreach_mul(traces, momentum))
    return traces


class SGD(_Written):
    """optax's ``sgd``: with ``momentum``, the trace ``t = g + momentum * t``
    and the update ``t``, or ``g + momentum * t`` with ``nesterov``;
    without, the gradient.  The parameter moves by ``-lr`` times the
    update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, momentum: Optional[float] = None,
                 nesterov: bool = False):
        super().__init__(params, {"lr": float(lr), "momentum": None if momentum is None else float(momentum),
                                  "nesterov": bool(nesterov)})

    def init_state(self, p, group):
        state = super().init_state(p, group)
        if group["momentum"] is not None:
            state["trace"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state

    def update(self, params, grads, states, group):
        if group["momentum"] is None:
            return grads
        return _trace(group["momentum"], grads, [state["trace"] for state in states], group["nesterov"])


class RMSprop(_Written):
    """optax's ``rmsprop``: per parameter ``nu = (1 - decay) * g**2 + decay
    * nu`` from ``nu = initial_scale``; ``centered`` also keeps ``mu = (1 -
    decay) * g + decay * mu`` and takes ``nu - mu**2``; ``bias_correction``
    divides both by ``1 - decay**step``; the scale is ``rsqrt(nu + eps)``
    (``eps_in_sqrt``) or ``1 / (sqrt(nu) + eps)``; the update ``-lr * g *
    scale``, then, when ``momentum`` is not None, optax's ``trace``: ``t =
    u + momentum * t``, applied as the update (``u + momentum * t`` with
    ``nesterov``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, decay: float, eps: float,
                 initial_scale: float = 0.0, momentum: Optional[float] = None, eps_in_sqrt: bool = True,
                 centered: bool = False, nesterov: bool = False, bias_correction: bool = False):
        super().__init__(params, {"lr": float(lr), "decay": float(decay), "eps": float(eps),
                                  "initial_scale": float(initial_scale),
                                  "momentum": None if momentum is None else float(momentum),
                                  "eps_in_sqrt": bool(eps_in_sqrt), "centered": bool(centered),
                                  "nesterov": bool(nesterov), "bias_correction": bool(bias_correction)})

    def init_state(self, p, group):
        # optax's rmsprop counts its updates only to correct the bias
        state = super().init_state(p, group) if group["bias_correction"] else {}
        state["nu"] = torch.full_like(p, group["initial_scale"], memory_format=torch.preserve_format)
        if group["centered"]:
            state["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        if group["momentum"] is not None:
            state["trace"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state

    def update(self, params, grads, states, group):
        decay = group["decay"]
        nus = [state["nu"] for state in states]
        torch._foreach_mul_(nus, decay)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - decay))
        nu_hat, mu_hat = nus, None
        if group["centered"]:
            mu_hat = [state["mu"] for state in states]
            torch._foreach_mul_(mu_hat, decay)
            torch._foreach_add_(mu_hat, torch._foreach_mul(grads, 1.0 - decay))
        if group["bias_correction"]:
            corrections = _bias_corrections(decay, torch._foreach_add([state["step"] for state in states], 1.0))
            nu_hat = torch._foreach_div(nu_hat, corrections)
            mu_hat = None if mu_hat is None else torch._foreach_div(mu_hat, corrections)
        if mu_hat is not None:
            nu_hat = torch._foreach_sub(nu_hat, torch._foreach_mul(mu_hat, mu_hat))
        if group["eps_in_sqrt"]:
            scale = torch._foreach_add(nu_hat, group["eps"])
            torch._foreach_rsqrt_(scale)
        else:
            scale = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(scale, group["eps"])
            torch._foreach_reciprocal_(scale)
        return torch._foreach_mul(scale, grads)

    def after_rate(self, updates, states, group):
        if group["momentum"] is None:
            return updates
        return _trace(group["momentum"], updates, [state["trace"] for state in states], group["nesterov"])


class OptaxAdam(_Written):
    """optax's ``scale_by_adam`` with ``eps_root``, ``mu_dtype`` (the first
    moment stored in that dtype) and ``nesterov`` (Dozat's), written out:
    ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g**2 + b2 * nu``,
    each bias-corrected, the update ``mu / (sqrt(nu + eps_root) + eps)``;
    with ``weight_decay`` (optax's ``adamw``) ``+ weight_decay * p`` where
    ``mask`` allows.  The state is torch Adam's ``step``, ``exp_avg`` and
    ``exp_avg_sq``.  ``mask`` is one bool a parameter, in the order the
    optimizer takes them, or a callable of the parameter list giving them
    (optax's mask is a tree of bools laid out like the params)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, mu_dtype: Optional[str] = None, nesterov: bool = False,
                 weight_decay: Optional[float] = None, mask: Any = None):
        params = list(params)
        super().__init__(params, {"lr": float(lr), "b1": float(b1), "b2": float(b2), "eps": float(eps),
                                  "eps_root": float(eps_root), "mu_dtype": mu_dtype, "nesterov": bool(nesterov),
                                  "weight_decay": None if weight_decay is None else float(weight_decay)})
        flat = [p for group in self.param_groups for p in group["params"]]
        if mask is not None:
            mask = [bool(m) for m in (mask(flat) if callable(mask) else mask)]
            if len(mask) != len(flat):
                raise ValueError(f"mask has {len(mask)} entries for {len(flat)} parameters")
        self.mask = mask
        self._decays = {id(p): mask is None or mask[i] for i, p in enumerate(flat)}

    def init_state(self, p, group):
        state = super().init_state(p, group)
        state["exp_avg"] = torch.zeros_like(p, dtype=_dtype(group["mu_dtype"]) or p.dtype)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state

    def update(self, params, grads, states, group):
        b1, b2 = group["b1"], group["b2"]
        stored = [state["exp_avg"] for state in states]
        mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1), _decayed(b1, stored, _dtype(group["mu_dtype"])))
        nus = [state["exp_avg_sq"] for state in states]
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        counts = torch._foreach_add([state["step"] for state in states], 1.0)
        if group["nesterov"]:
            ahead = torch._foreach_div(mu, _bias_corrections(b1, torch._foreach_add(counts, 1.0)))
            mu_hat = torch._foreach_add(torch._foreach_mul(ahead, b1), torch._foreach_mul(
                torch._foreach_div(grads, _bias_corrections(b1, counts)), 1.0 - b1))
        else:
            mu_hat = torch._foreach_div(mu, _bias_corrections(b1, counts))
        scale = torch._foreach_div(nus, _bias_corrections(b2, counts))
        torch._foreach_add_(scale, group["eps_root"])
        torch._foreach_sqrt_(scale)
        torch._foreach_add_(scale, group["eps"])
        updates = torch._foreach_div(mu_hat, scale)
        torch._foreach_copy_(stored, mu)
        if group["weight_decay"] is not None:
            decayed = [i for i, p in enumerate(params) if self._decays[id(p)]]
            if decayed:
                torch._foreach_add_([updates[i] for i in decayed],
                                    torch._foreach_mul([params[i] for i in decayed], group["weight_decay"]))
        return updates


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Callable[[Iterable[torch.nn.Parameter]], Any]:
    """A factory of optax's ``adam`` over the parameters it is given:
    ``torch.optim.Adam`` at ``eps_root=0``, else :class:`OptaxAdam`."""
    if eps_root == 0.0:
        return functools.partial(torch.optim.Adam, lr=float(learning_rate), betas=(float(b1), float(b2)),
                                 eps=float(eps))
    return functools.partial(OptaxAdam, lr=float(learning_rate), b1=float(b1), b2=float(b2), eps=float(eps),
                             eps_root=float(eps_root))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: Optional[str] = None, weight_decay: float = 1e-4, mask: Any = None,
          nesterov: bool = False) -> Callable[[Iterable[torch.nn.Parameter]], Any]:
    """A factory of optax's ``adamw`` over the parameters it is given:
    ``torch.optim.AdamW`` at the defaults of ``eps_root``, ``mu_dtype``,
    ``mask`` and ``nesterov``, else :class:`OptaxAdam` with the decay."""
    if eps_root == 0.0 and mu_dtype is None and mask is None and not nesterov:
        return functools.partial(torch.optim.AdamW, lr=float(learning_rate), betas=(float(b1), float(b2)),
                                 eps=float(eps), weight_decay=float(weight_decay))
    return functools.partial(OptaxAdam, lr=float(learning_rate), b1=float(b1), b2=float(b2), eps=float(eps),
                             eps_root=float(eps_root), mu_dtype=mu_dtype, nesterov=bool(nesterov),
                             weight_decay=float(weight_decay), mask=mask)


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0,
            momentum: Optional[float] = None, eps_in_sqrt: bool = True, centered: bool = False,
            nesterov: bool = False, bias_correction: bool = False) -> Callable[[Iterable[torch.nn.Parameter]], RMSprop]:
    """A factory of :class:`RMSprop` (optax's ``rmsprop``) over the
    parameters it is given."""
    return functools.partial(RMSprop, lr=float(learning_rate), decay=float(decay), eps=float(eps),
                             initial_scale=float(initial_scale), momentum=None if momentum is None else float(momentum),
                             eps_in_sqrt=bool(eps_in_sqrt), centered=bool(centered), nesterov=bool(nesterov),
                             bias_correction=bool(bias_correction))


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> Callable[[Iterable[torch.nn.Parameter]], SGD]:
    """A factory of :class:`SGD` (optax's ``sgd``) over the parameters it is
    given."""
    return functools.partial(SGD, lr=float(learning_rate), momentum=None if momentum is None else float(momentum),
                             nesterov=bool(nesterov))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: each tensor scaled by
    ``max_norm / norm`` when the global norm (``norm``, the tensors' own by
    default) reaches ``max_norm``, as is otherwise.  Stays on the device: no
    host sync."""
    norm = global_norm(tensors) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, t, t / norm.to(t.dtype) * max_norm) for t in tensors]
