"""Optimizers named by the configs (counterpart of the optax transforms the
JAX package instantiates).

``configs/optim/adam.yaml`` targets :func:`adam` with optax's keys
(``learning_rate``, ``b1``, ``b2``, ``eps``), so a JAX run's archived config
still reads.  Both put ``eps`` outside the square root (optax
``eps_root = 0``), so ``torch.optim.Adam`` is the same update.  Gradient
clipping is optax's ``clip_by_global_norm``, written out: torch's
``clip_grad_norm_`` divides by ``norm + 1e-6`` and always rescales.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, List, Sequence

import torch


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.Adam]:
    """A factory of ``torch.optim.Adam`` over the parameters it is given."""
    if eps_root != 0.0:
        raise NotImplementedError("adam with eps_root != 0 has no torch.optim.Adam counterpart")
    return functools.partial(torch.optim.Adam, lr=float(learning_rate), betas=(float(b1), float(b2)),
                             eps=float(eps))


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
