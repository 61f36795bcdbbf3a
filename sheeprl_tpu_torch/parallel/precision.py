"""The precision policy (counterpart of ``sheeprl_tpu/parallel/precision.py``).

The JAX package's policy, not ``torch.autocast``'s:

- ``bf16-mixed`` (and ``16-mixed``, which means the same there): parameters
  stay fp32 (master weights); inside each loss the parameters **and** the
  network inputs are cast to bf16, so every layer, LayerNorm and the
  LayerNorm-GRU kernel included, runs in bf16, and the gradient of the cast
  brings fp32 gradients back to the fp32 masters.  Optimizer state stays
  fp32.
- ``bf16-true``: the parameters themselves are stored in bf16 after init;
  the per-loss cast is then the identity and the optimizer state is bf16.
- numerics-sensitive math (log-probs, two-hot, lambda targets, Moments)
  runs in fp32: the distributions upcast what they are built from.

``torch.autocast`` casts only the ops on its lists and keeps LayerNorm and
softmax in fp32, which would drift from the JAX numbers and hand the GRU
kernel inputs of mixed dtypes.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Tuple

import torch
from torch import nn

# precision name -> (param_dtype, compute_dtype)
PRECISION_DTYPES = {
    "32-true": (torch.float32, torch.float32),
    "16-mixed": (torch.float32, torch.bfloat16),
    "bf16-mixed": (torch.float32, torch.bfloat16),
    "bf16-true": (torch.bfloat16, torch.bfloat16),
    "64-true": (torch.float64, torch.float64),
}


def resolve_precision(precision: str) -> Tuple[torch.dtype, torch.dtype]:
    """``precision`` name -> ``(param_dtype, compute_dtype)``."""
    if precision not in PRECISION_DTYPES:
        raise ValueError(f"Unknown precision '{precision}'; valid: {list(PRECISION_DTYPES)}")
    return PRECISION_DTYPES[precision]


def compute_dtype_of(cfg) -> torch.dtype:
    """The compute dtype implied by ``cfg.fabric.precision`` (fp32 default)."""
    fabric = cfg.get("fabric") or {}
    return resolve_precision(fabric.get("precision", "32-true"))[1]


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of ``tree`` (dicts, lists, tuples) cast to
    ``dtype``; other leaves pass through.  Differentiable."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


class _Holder(nn.Module):
    def __init__(self, modules: Iterable[nn.Module]):
        super().__init__()
        self.held = nn.ModuleList(modules)

    def forward(self, fn: Callable[[], Any]) -> Any:
        return fn()


def call_cast(modules: Iterable[nn.Module], dtype: torch.dtype, fn: Callable[[], Any],
              buffers: bool = True) -> Any:
    """``fn()`` with every floating parameter and buffer of ``modules``
    replaced, for the call, by its cast to ``dtype`` (``cast_floating`` of
    the parameter tree, as each JAX loss applies it).  The cast is part of
    the autograd graph, so a gradient taken of ``fn``'s result over the
    modules' own parameters arrives at them in their dtype.  Where every
    tensor already has ``dtype``, ``fn`` runs as it is.  Without
    ``buffers`` the buffers keep their dtype (a JAX module's constants
    that are not in its param tree)."""
    holder = _Holder(modules)
    tensors = {**dict(holder.named_parameters()), **(dict(holder.named_buffers()) if buffers else {})}
    if all(t.dtype == dtype for t in tensors.values() if t.is_floating_point()):
        return fn()
    return torch.func.functional_call(holder, cast_floating(tensors, dtype), (fn,))
