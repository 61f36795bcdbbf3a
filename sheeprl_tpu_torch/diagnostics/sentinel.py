"""NaN/divergence sentinel (counterpart of
``sheeprl_tpu/diagnostics/sentinel.py``): finiteness guards inside the
gradient step and a host-side divergence detector.

* **On the device**: the step's metric vector (every loss and gradient
  norm) reduces to one finiteness flag.  Under ``policy=skip_update`` the
  step's parameter, optimizer-state and Moments updates are discarded by a
  ``torch.where`` selection against copies taken before the step, with no
  host sync: a poisoned batch costs one wasted step.  The flag itself rides
  the metric vector to the host at the log interval's one fetch, where
  ``warn`` warns and ``halt`` raises.
* **On the host** (:class:`DivergenceDetector`): rolling-window checks on
  the aggregated metric stream at each log boundary (entropy floor, loss
  explosion against the window median), returned as ``divergence`` events;
  the detector never stops a run by itself.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence

import torch

VALID_POLICIES = ("warn", "skip_update", "halt")


class SentinelHalt(RuntimeError):
    """Raised (host-side) when a non-finite update lands under ``policy=halt``."""


class SentinelSpec(NamedTuple):
    """The sentinel's configuration, read once by ``make_train_step``."""

    enabled: bool = False
    policy: str = "warn"
    inject_nan_iter: Optional[int] = None

    @property
    def skip_update(self) -> bool:
        return self.enabled and self.policy == "skip_update"


def sentinel_spec(cfg: Mapping[str, Any]) -> SentinelSpec:
    """The :class:`SentinelSpec` of a composed run config; a config without
    a ``diagnostics`` section means disabled."""
    diag = cfg.get("diagnostics") or {}
    sent = diag.get("sentinel") or {}
    enabled = bool(diag.get("enabled", False)) and bool(sent.get("enabled", False))
    policy = str(sent.get("policy", "warn"))
    if policy not in VALID_POLICIES:
        raise ValueError(f"diagnostics.sentinel.policy must be one of {VALID_POLICIES}, got {policy!r}")
    inject = sent.get("inject_nan_iter")
    return SentinelSpec(enabled=enabled, policy=policy, inject_nan_iter=None if inject is None else int(inject))


def finite_flag(*scalars: torch.Tensor) -> torch.Tensor:
    """A 0-d bool tensor, True iff every scalar is finite (on their device;
    no host sync).  The global gradient norm stands for every gradient: any
    NaN/Inf element makes it NaN/Inf."""
    return torch.isfinite(torch.stack([torch.as_tensor(s).float().reshape(()) for s in scalars])).all()


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def tree_all_finite(tree: Any) -> torch.Tensor:
    """Finiteness flag over every floating tensor of a tree (no host sync)."""
    leaves = [t for t in _leaves(tree) if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


@torch.no_grad()
def select_finite(finite: torch.Tensor, new: Sequence[torch.Tensor], old: Sequence[torch.Tensor]) -> None:
    """The skip_update selection, in place: each tensor of ``new`` becomes
    ``where(finite, new, old)``.  ``finite`` is a 0-d bool tensor on the
    tensors' device, so nothing waits for the host; NaNs in the rejected
    branch are inert under ``where``."""
    for n, o in zip(new, old):
        n.copy_(torch.where(finite.to(n.device), n, o))


def skip_update_guard(modules: Iterable[torch.nn.Module], optimizers: Iterable[torch.optim.Optimizer]):
    """What ``policy=skip_update`` reverts, and a buffer for each: the
    parameters of ``modules`` and every optimizer state tensor, Adam's
    ``step`` included.  Adam's state is created here (zeros, step 0, as its
    first step would create it) so that a skipped first step has something
    to revert to; the port's ``RMSprop`` makes its state at construction.
    On the card Adam runs ``capturable``, which keeps ``step`` on the
    device: the selection then never waits for the host."""
    guarded = [p for module in modules for p in module.parameters()]
    for opt in optimizers:
        if not isinstance(opt, torch.optim.Adam):
            guarded += [t for group in opt.param_groups for p in group["params"] for t in opt.state[p].values()]
            continue
        for group in opt.param_groups:
            on_card = any(p.device.type == "cuda" for p in group["params"])
            group["capturable"] = group["capturable"] or on_card
            for p in group["params"]:
                state = opt.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if group["capturable"]:
                    state["step"] = state["step"].to(p.device)
                guarded += [state["step"], state["exp_avg"], state["exp_avg_sq"]]
    return guarded, [torch.empty_like(t) for t in guarded]


def poison_tree(tree: Any) -> Any:
    """A copy of ``tree`` with every floating tensor filled with NaN (fault
    injection for drills); shapes, dtypes and devices are kept, and integer
    and bool leaves pass through."""
    if isinstance(tree, Mapping):
        return type(tree)((k, poison_tree(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(poison_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return torch.full_like(tree, float("nan"))
    return tree


# --------------------------------------------------------------------------
# Host-side rolling divergence detector
# --------------------------------------------------------------------------


class DivergenceDetector:
    """Rolling-window divergence checks over the aggregated metric stream.

    Fed once per log boundary (so windows are cheap and host-side only);
    returns structured event dicts for the journal:

    * ``entropy_collapse`` — ``entropy_key``'s *magnitude* falls below
      ``entropy_floor``.  Collapse drives the policy entropy toward 0, which
      is a shrinking magnitude both for true-entropy metrics and for
      PPO-style ``Loss/entropy_loss`` (negative entropy), so one floor works
      for either sign convention.
    * ``loss_explosion`` — a watched ``Loss/*`` metric jumps above
      ``loss_explosion_ratio`` x its rolling median magnitude.
    * ``nonfinite_metric`` — a watched metric arrives as NaN/Inf (aggregators
      normally drop NaNs before logging, so this mostly fires via the raw
      journal path).
    """

    def __init__(
        self,
        window: int = 20,
        min_points: int = 5,
        loss_explosion_ratio: float = 10.0,
        entropy_key: Optional[str] = None,
        entropy_floor: Optional[float] = None,
        watch_prefixes: Sequence[str] = ("Loss/",),
    ):
        if window < 2:
            raise ValueError(f"divergence window must be >= 2, got {window}")
        self._window = int(window)
        self._min_points = max(2, int(min_points))
        self._ratio = float(loss_explosion_ratio) if loss_explosion_ratio else 0.0
        self._entropy_key = entropy_key
        self._entropy_floor = None if entropy_floor is None else float(entropy_floor)
        self._watch_prefixes = tuple(watch_prefixes)
        self._history: Dict[str, deque] = {}

    def _watched(self, name: str) -> bool:
        return any(name.startswith(p) for p in self._watch_prefixes)

    def observe(self, step: int, metrics: Mapping[str, Any]) -> List[Dict[str, Any]]:
        import numpy as np

        events: List[Dict[str, Any]] = []
        for name, value in metrics.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            if name == self._entropy_key and self._entropy_floor is not None and np.isfinite(v):
                if abs(v) < abs(self._entropy_floor):
                    events.append(
                        {
                            "kind": "entropy_collapse",
                            "metric": name,
                            "value": v,
                            "floor": self._entropy_floor,
                            "step": step,
                        }
                    )
            if not self._watched(name):
                continue
            if not np.isfinite(v):
                events.append({"kind": "nonfinite_metric", "metric": name, "value": v, "step": step})
                continue
            hist = self._history.setdefault(name, deque(maxlen=self._window))
            if self._ratio and len(hist) >= self._min_points:
                baseline = float(np.median(np.abs(np.asarray(hist))))
                if baseline > 1e-8 and abs(v) > self._ratio * baseline:
                    events.append(
                        {
                            "kind": "loss_explosion",
                            "metric": name,
                            "value": v,
                            "baseline_median": baseline,
                            "ratio": abs(v) / baseline,
                            "step": step,
                        }
                    )
            hist.append(v)
        return events
