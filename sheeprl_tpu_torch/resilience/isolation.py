"""Fault isolation for the decoupled topology (counterpart of
``sheeprl_tpu/resilience/isolation.py``): the last-good parameter fence and
the train-step quarantine with rollback.

The player of a decoupled run tolerates learner trouble: a learner update
that judges unhealthy is not handed to the player, and a train-step failure
rolls the learner back to the last parameters known to be good.  Two
mechanisms, both configured by ``diagnostics.resilience.isolation``:

* **Promotion gate** (:meth:`IsolationMonitor.judge`): the trainer->player
  hand-off happens only when the update judges healthy, from signals the
  loop already fetched (the non-finite count and the ``health_stats``
  norms).  A rejection journals ``params_reject`` and the player keeps its
  parameters; ``Telemetry/param_staleness`` counts the rejections in a row.
  Past ``max_staleness`` the monitor arms a fence halt: the loop forces its
  checkpoint branch and raises :class:`IsolationHalt`.
* **Quarantine and rollback** (:meth:`IsolationMonitor.rollback`): every
  healthy promotion refreshes a host copy of the trainer's parameters and
  optimizer state, double-buffered (the refresh fills the spare slot and
  then swaps, so an interrupt mid-refresh never tears the restore source).
  A halting sentinel or a chaos ``trainer_exception`` restores from it,
  journals ``rollback`` and goes on; ``retry_budget`` bounds the incidents.

Only the decoupled loops (``algos/ppo/ppo_decoupled.py``,
``algos/sac/sac_decoupled.py``) call the hooks, as in the JAX package: the
coupled loops' runs carry only the counters and the closing summary.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.diagnostics.sentinel import SentinelHalt


class IsolationHalt(SentinelHalt):
    """Raised when the parameter-staleness budget is exhausted (after the
    emergency snapshot landed); a :class:`SentinelHalt`, so the CLI closes
    the run as ``halted``."""


def host_tensors(tree: Any) -> Any:
    """A self-owned host copy of a tree of tensors: every tensor detached
    and copied to a CPU tensor of its own dtype, numpy arrays copied,
    containers rebuilt; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, Mapping):
        return {k: host_tensors(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(host_tensors(v) for v in tree)
    return tree


def _int_knob(iso_cfg: Mapping[str, Any], key: str, default: int, least: int) -> int:
    raw = iso_cfg.get(key)
    value = default if raw is None else int(raw)
    if value < least:
        raise ValueError(f"diagnostics.resilience.isolation.{key} must be >= {least}, got {value}")
    return value


class IsolationMonitor:
    """Promotion gate and last-good snapshot behind ``ResilienceMonitor``.

    Configured by ``diagnostics.resilience.isolation``: ``enabled``;
    ``max_staleness``, rejected promotions in a row before the fence halts;
    ``retry_budget``, rollbacks before a quarantined failure re-raises;
    ``reject_on_anomaly``, also fence while a learning-health detector has
    an open anomaly; ``refresh_every``, healthy promotions per snapshot.
    """

    def __init__(self, cfg: Optional[Mapping[str, Any]]):
        cfg = cfg or {}
        iso_cfg = ((cfg.get("diagnostics") or {}).get("resilience") or {}).get("isolation") or {}
        self.enabled = bool(iso_cfg.get("enabled", True))
        self.max_staleness = _int_knob(iso_cfg, "max_staleness", 8, 1)
        self.retry_budget = _int_knob(iso_cfg, "retry_budget", 3, 0)
        self.reject_on_anomaly = bool(iso_cfg.get("reject_on_anomaly", True))
        self.refresh_every = _int_knob(iso_cfg, "refresh_every", 1, 1)

        self._journal_fn: Optional[Callable[..., None]] = None
        self._sync_fn: Optional[Callable[[], None]] = None
        self._opened = False
        self._gate_used = False
        self.staleness = 0
        self._rejected_total = 0
        self._halt_due = False
        # double-buffered: refresh fills the spare slot, then one reference
        # assignment makes it current
        self._slots: list = [None, None]
        self._current: Optional[int] = None
        self._rollbacks_total = 0
        self._retries_left = self.retry_budget
        self._healthy_promotions = 0

    # -- lifecycle -----------------------------------------------------------
    def open(self, journal_fn: Optional[Callable[..., None]] = None,
             sync_fn: Optional[Callable[[], None]] = None) -> None:
        if self._opened:
            return
        self._journal_fn = journal_fn
        self._sync_fn = sync_fn
        self._opened = True

    def _journal(self, event: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(event, **fields)

    # -- promotion gate ------------------------------------------------------
    @staticmethod
    def _nonfinite_stat(stats: Mapping[str, Any]) -> Optional[str]:
        """The first non-finite global health norm, or None (per-module
        detail is not judged: a dead module's zero must not veto)."""
        for key in ("grad_norm", "update_norm", "param_norm"):
            value = stats.get(key)
            if value is None:
                continue
            try:
                if not math.isfinite(float(value)):
                    return key
            except (TypeError, ValueError):
                continue
        return None

    def judge(self, iter_num: int, step: Optional[int], stats: Mapping[str, Any], nonfinite: float = 0.0,
              anomalies: Sequence[str] = ()) -> bool:
        """One promotion verdict: True hands the parameters to the player.

        Reject reasons, first match wins: ``nonfinite_update`` (the step
        counted non-finite optimizer steps), ``nonfinite:<stat>`` (a health
        norm is NaN or inf), ``open_anomaly:<kinds>`` (with
        ``reject_on_anomaly``).  A rejection journals ``params_reject``;
        only a non-finite one past ``max_staleness`` arms the fence halt
        (once, fsync'd): an open anomaly fences but never ends a run.
        """
        if not self._opened or not self.enabled:
            return True
        self._gate_used = True
        reason = None
        if nonfinite and float(nonfinite) > 0:
            reason = "nonfinite_update"
        if reason is None:
            bad = self._nonfinite_stat(stats or {})
            if bad is not None:
                reason = f"nonfinite:{bad}"
        if reason is None and self.reject_on_anomaly and anomalies:
            reason = "open_anomaly:" + ",".join(sorted(anomalies)[:4])
        if reason is None:
            self.staleness = 0
            return True
        self.staleness += 1
        self._rejected_total += 1
        escalate = self.staleness > self.max_staleness and not self._halt_due \
            and not reason.startswith("open_anomaly")
        self._journal("params_reject", reason=reason, step=step, iter_num=int(iter_num), staleness=self.staleness,
                      budget=self.max_staleness, escalate=escalate)
        if escalate:
            self._halt_due = True
            if self._sync_fn is not None:
                self._sync_fn()
        return False

    @property
    def halt_due(self) -> bool:
        """True once staleness exhausted its budget: the loop forces its
        checkpoint branch and raises through ``Diagnostics.on_fence_halt``."""
        return self._halt_due

    # -- last-good snapshot --------------------------------------------------
    def refresh(self, iter_num: int, params: Any, opt_state: Any) -> None:
        """Refresh the last-good host copy after a healthy promotion, into
        the spare slot.  Every ``refresh_every``-th healthy promotion copies;
        the first always does, so rollback is armed as early as possible."""
        if not self._opened or not self.enabled:
            return
        self._healthy_promotions += 1
        if self._current is not None and (self._healthy_promotions - 1) % self.refresh_every != 0:
            return
        spare = 1 - (self._current if self._current is not None else 1)
        self._slots[spare] = {"params": host_tensors(params), "opt_state": host_tensors(opt_state),
                              "iter_num": int(iter_num)}
        self._current = spare

    @property
    def last_good(self) -> Optional[Dict[str, Any]]:
        return self._slots[self._current] if self._current is not None else None

    def can_absorb(self) -> bool:
        """True while a quarantined failure could be rolled back: armed, a
        snapshot exists, retries remain and no fence halt is due."""
        return self._opened and self.enabled and self._current is not None and self._retries_left > 0 \
            and not self._halt_due

    def rollback(self, err: BaseException, iter_num: int, step: Optional[int]) -> Optional[Dict[str, Any]]:
        """Spend one retry and return the last-good ``{params, opt_state,
        iter_num}`` for the caller to load back, or None when nothing can be
        restored (the caller then re-raises)."""
        if not self.can_absorb():
            return None
        self._retries_left -= 1
        self._rollbacks_total += 1
        restored = self.last_good
        self._journal("rollback", iter_num=int(iter_num), step=step, error=repr(err)[:200],
                      restored_iter=restored["iter_num"], retries_left=self._retries_left, budget=self.retry_budget)
        if self._sync_fn is not None:
            self._sync_fn()
        return restored

    # -- observability -------------------------------------------------------
    def interval_metrics(self) -> Dict[str, float]:
        """The staleness gauge, once the gate has been consulted (coupled
        runs never grow the key)."""
        if not self._gate_used:
            return {}
        return {"Telemetry/param_staleness": float(self.staleness)}

    def gauges(self) -> Dict[str, float]:
        if not self._gate_used:
            return {}
        return {"Telemetry/param_staleness": float(self.staleness),
                "Telemetry/param_staleness_budget": float(self.max_staleness)}

    def counters(self) -> Dict[str, Any]:
        return {"params_rejected_total": self._rejected_total, "rollbacks_total": self._rollbacks_total}

    def summary(self) -> Dict[str, Any]:
        return {"params_rejected": self._rejected_total, "rollbacks": self._rollbacks_total,
                "rollback_retries_left": self._retries_left}
