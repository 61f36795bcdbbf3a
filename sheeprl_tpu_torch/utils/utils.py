"""Host-side helpers (counterpart of ``sheeprl_tpu/utils/utils.py``): the
config containers, the coefficient decay, the replay-ratio budgeter and the
run-config archive."""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Mapping, Optional


class dotdict(dict):
    """A dictionary supporting dot notation."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, dotdict):
                self[k] = dotdict(v)

    def __getstate__(self):
        return dict(self)

    def __setstate__(self, state):
        self.update(state)

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.as_dict() if isinstance(v, dotdict) else v
        return out


def nest_dotted(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Turn ``{"a.b": 1}`` into ``{"a": {"b": 1}}``."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def polynomial_decay(current_step: int, *, initial: float = 1.0, final: float = 0.0, max_decay_steps: int = 100,
                     power: float = 1.0) -> float:
    """A coefficient decayed polynomially from ``initial`` to ``final`` over
    ``max_decay_steps`` steps (PPO's clip and entropy annealing)."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


class Ratio:
    """Gradient-step budgeter: how many optimizer steps the trainer owes the
    policy-step counter at a replay ratio.  Every call banks
    ``(step - last_step) * ratio`` of credit and pays out its integer part,
    so over a run exactly ``ratio`` gradient steps happen per policy step.
    The first call pays a pretrain burst of ``pretrain_steps * ratio``
    instead (clamped to the steps taken so far)."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._ratio = float(ratio)
        self._pretrain_steps = int(pretrain_steps)
        self._last_step: Optional[float] = None
        self._credit = 0.0

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        if self._last_step is None:
            self._last_step = step
            burst = self._pretrain_steps
            if burst > 0 and step < burst:
                warnings.warn(
                    f"pretrain_steps ({burst}) exceeds the policy steps taken so far ({step}); "
                    f"clamping the pretrain burst to {step} steps to keep the effective "
                    f"replay ratio at {self._ratio}."
                )
                self._pretrain_steps = burst = step
            return int((burst if burst > 0 else step) * self._ratio)
        self._credit += (step - self._last_step) * self._ratio
        self._last_step = step
        repeats = int(self._credit)
        self._credit -= repeats
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"ratio": self._ratio, "last_step": self._last_step, "credit": self._credit,
                "pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state_dict: Mapping[str, Any]) -> "Ratio":
        # the older key names too, as the JAX package reads them
        self._ratio = state_dict.get("ratio", state_dict.get("_ratio"))
        self._last_step = state_dict.get("last_step", state_dict.get("_prev"))
        self._credit = state_dict.get("credit", 0.0)
        self._pretrain_steps = state_dict.get("pretrain_steps", state_dict.get("_pretrain_steps", 0))
        if self._ratio is None:
            raise KeyError(f"Unrecognized Ratio state: {sorted(state_dict)}")
        return self


def get_diagnostics(runtime, cfg: Mapping[str, Any], log_dir: str):
    """The run's opened :class:`~sheeprl_tpu_torch.diagnostics.Diagnostics`:
    the one ``cli.run_algorithm`` attached to the runtime, or one built here
    from ``cfg`` for a direct caller; opened (idempotently) in ``log_dir``
    on the runtime's device, as its process's rank."""
    from sheeprl_tpu_torch.diagnostics import build_diagnostics

    diag = getattr(runtime, "diagnostics", None)
    if diag is None:
        diag = runtime.diagnostics = build_diagnostics(cfg)
    return diag.open(log_dir, device=runtime.device, rank=getattr(runtime, "global_rank", 0))


def save_configs(cfg: dotdict, log_dir: str) -> None:
    """Archive the run config as ``<log_dir>/config.yaml``, which ``serve``
    reads back next to the checkpoints."""
    import yaml

    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.yaml"), "w") as fp:
        yaml.safe_dump(cfg.as_dict() if isinstance(cfg, dotdict) else dict(cfg), fp, sort_keys=False)
