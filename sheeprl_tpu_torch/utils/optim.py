"""Optimizers named by the configs (counterpart of the optax transforms the
JAX package instantiates).

``configs/optim/adam.yaml`` targets :func:`adam` with optax's keys
(``learning_rate``, ``b1``, ``b2``, ``eps``), so a JAX run's archived config
still reads.  Both put ``eps`` outside the square root (optax
``eps_root = 0``), so ``torch.optim.Adam`` is the same update.  ``configs/optim/adamw.yaml``
targets :func:`adamw`, optax's ``adamw`` as ``torch.optim.AdamW``: both
take ``p - lr * wd * p - lr * adam(p)`` from the old ``p``.
``configs/optim/rmsprop.yaml`` targets :func:`rmsprop`, optax's update
written out (:class:`RMSprop`): optax puts ``eps`` inside the square root
and follows the scaled update with a momentum trace, where
``torch.optim.RMSprop`` puts ``eps`` outside and keeps no trace at
``momentum=0``.  Gradient clipping is optax's ``clip_by_global_norm``,
written out: torch's ``clip_grad_norm_`` divides by ``norm + 1e-6`` and
always rescales.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.Adam]:
    """A factory of ``torch.optim.Adam`` over the parameters it is given."""
    if eps_root != 0.0:
        raise NotImplementedError("adam with eps_root != 0 has no torch.optim.Adam counterpart")
    return functools.partial(torch.optim.Adam, lr=float(learning_rate), betas=(float(b1), float(b2)),
                             eps=float(eps))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: Optional[str] = None, weight_decay: float = 1e-4, mask: Any = None,
          nesterov: bool = False) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.AdamW]:
    """A factory of ``torch.optim.AdamW`` over the parameters it is given,
    with optax's keys and defaults (``weight_decay`` 1e-4).  The variants
    optax selects with ``mask``, ``nesterov``, ``mu_dtype`` or ``eps_root``
    are not ported."""
    other = {"mask": (mask, None), "nesterov": (nesterov, False), "mu_dtype": (mu_dtype, None),
             "eps_root": (eps_root, 0.0)}
    unported = [f"{k}={v}" for k, (v, default) in other.items() if v != default]
    if unported:
        raise NotImplementedError(f"adamw with {', '.join(unported)} is not ported yet (see ROADMAP.md Queue 1)")
    return functools.partial(torch.optim.AdamW, lr=float(learning_rate), betas=(float(b1), float(b2)),
                             eps=float(eps), weight_decay=float(weight_decay))


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` (``eps_in_sqrt=True``, not centered): per
    parameter ``nu = decay * nu + (1 - decay) * g**2`` from ``nu =
    initial_scale``, the update ``u = -lr * g / sqrt(nu + eps)``, then, when
    ``momentum`` is not None, optax's ``trace``: ``t = u + momentum * t``,
    applied as the update.  The state (``nu``, ``trace``) exists from
    construction on, as optax's ``init`` makes it, so a state a checkpoint
    holds loads before the first step and ``skip_update`` has a state to
    revert to."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, decay: float, eps: float,
                 initial_scale: float = 0.0, momentum: Optional[float] = None):
        super().__init__(params, {"lr": float(lr), "decay": float(decay), "eps": float(eps),
                                  "momentum": None if momentum is None else float(momentum)})
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                state["nu"] = torch.full_like(p, float(initial_scale), memory_format=torch.preserve_format)
                if group["momentum"] is not None:
                    state["trace"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("RMSprop.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - group["decay"]))
            updates = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(updates)
            torch._foreach_mul_(updates, grads)
            torch._foreach_mul_(updates, -group["lr"])
            if group["momentum"] is not None:
                traces = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(traces, group["momentum"])
                torch._foreach_add_(traces, updates)
                updates = traces
            torch._foreach_add_(params, updates)


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0,
            momentum: Optional[float] = None, eps_in_sqrt: bool = True, centered: bool = False,
            nesterov: bool = False, bias_correction: bool = False) -> Callable[[Iterable[torch.nn.Parameter]], RMSprop]:
    """A factory of :class:`RMSprop` over the parameters it is given, with
    optax's keys and defaults.  The variants optax selects with its other
    keys are not ported (ROADMAP.md Queue 1)."""
    other = {"eps_in_sqrt": (eps_in_sqrt, True), "centered": (centered, False), "nesterov": (nesterov, False),
             "bias_correction": (bias_correction, False)}
    unported = [f"{k}={v}" for k, (v, default) in other.items() if bool(v) != default]
    if unported:
        raise NotImplementedError(f"rmsprop with {', '.join(unported)} is not ported yet (see ROADMAP.md Queue 1)")
    return functools.partial(RMSprop, lr=float(learning_rate), decay=float(decay), eps=float(eps),
                             initial_scale=float(initial_scale), momentum=None if momentum is None else float(momentum))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: each tensor scaled by
    ``max_norm / norm`` when the global norm reaches ``max_norm``, as is
    otherwise.  Stays on the device: no host sync."""
    norm = global_norm(tensors)
    keep = norm < max_norm
    return [torch.where(keep, t, t / norm.to(t.dtype) * max_norm) for t in tensors]
