"""The resilience pillar behind the ``Diagnostics`` facade (counterpart of
``sheeprl_tpu/resilience/monitor.py``).

Owns the async checkpoint writer, the preemption guard and the checkpoint
bookkeeping behind the ``sheeprl_ckpt_*`` gauges and counters of
``/metrics``.  Configured by ``diagnostics.resilience``:

* ``async_checkpoint``: route ``Runtime.save`` through the background
  writer (one host snapshot on the critical path, pickling and fsync off
  it); ``False`` saves blocking, still manifest-verified and journaled;
* ``max_pending_snapshots``: how many snapshots may wait for the writer;
* ``preempt.enabled``: install the SIGTERM/SIGINT graceful-preemption guard;
* ``inject_preempt_iter``: behave as if a preemption signal arrived at the
  Nth loop iteration (the emergency snapshot -> ``preempted`` -> exit 75
  drill).

The JAX package's fault isolation (decoupled loops only) and scripted
chaos schedules are not ported (ROADMAP Queue 1); a non-null
``resilience.chaos.schedule`` raises.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Mapping, Optional

from sheeprl_tpu_torch.resilience.async_writer import AsyncCheckpointWriter
from sheeprl_tpu_torch.resilience.preemption import PreemptionGuard

#: set by a supervisor on every child it (re)spawns; exported as the
#: ``sheeprl_restarts_total`` counter
RESTARTS_ENV_VAR = "SHEEPRL_SUPERVISOR_RESTARTS"


class ResilienceMonitor:
    """Checkpoint writer, preemption guard and checkpoint freshness."""

    def __init__(self, cfg: Optional[Mapping[str, Any]], clock: Callable[[], float] = time.time):
        cfg = cfg or {}
        diag_cfg = cfg.get("diagnostics") or {}
        res_cfg = diag_cfg.get("resilience") or {}
        self.enabled = bool(res_cfg.get("enabled", True))
        if self.enabled and (res_cfg.get("chaos") or {}).get("schedule") is not None:
            raise NotImplementedError(
                "diagnostics.resilience.chaos.schedule (scripted chaos drills) is not ported yet: see ROADMAP.md "
                "Queue 1; the single-fault drills (sentinel.inject_nan_iter, resilience.inject_preempt_iter, "
                "memory.inject_*_iter, goodput.watchdog.inject_stall_iter) are"
            )
        self.async_checkpoint = bool(res_cfg.get("async_checkpoint", True))
        raw_pending = res_cfg.get("max_pending_snapshots")
        max_pending = 2 if raw_pending is None else int(raw_pending)
        if max_pending < 1:
            raise ValueError(f"diagnostics.resilience.max_pending_snapshots must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        preempt_cfg = res_cfg.get("preempt") or {}
        self.preempt_signals = bool(preempt_cfg.get("enabled", True))
        inject = res_cfg.get("inject_preempt_iter")
        self.inject_preempt_iter = None if inject is None else int(inject)

        self._clock = clock
        self._journal_fn: Optional[Callable[..., None]] = None
        self._writer: Optional[AsyncCheckpointWriter] = None
        self._writer_final_stats: Optional[Dict[str, Any]] = None
        self._guard: Optional[PreemptionGuard] = None
        self._opened = False
        self._inject_fired = False
        self._preempt_reason: Optional[str] = None
        self._restarts_total = 0
        # blocking-save bookkeeping (the writer keeps its own)
        self._sync_written = 0
        self._sync_failed = 0
        self._sync_write_seconds = 0.0
        self._last_end_t: Optional[float] = None
        self._last_interval_s: Optional[float] = None
        self._last_step: Optional[int] = None
        self._last_path: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------
    def open(self, journal_fn: Optional[Callable[..., None]] = None) -> None:
        if self._opened:
            return
        self._journal_fn = journal_fn
        self._opened = True
        try:
            self._restarts_total = int(os.environ.get(RESTARTS_ENV_VAR, "0") or 0)
        except ValueError:
            self._restarts_total = 0
        if self.async_checkpoint:
            self._writer = AsyncCheckpointWriter(journal_fn=self._journal, max_pending=self.max_pending)
        if self.preempt_signals:
            self._guard = PreemptionGuard()
            self._guard.install()

    def close(self) -> None:
        if not self._opened:
            return
        if self._writer is not None:
            # pending (possibly emergency) snapshots land, and journal their
            # ckpt_end, before the caller writes run_end
            self._writer.close()
            self._writer_final_stats = self._writer.stats()
            self._writer = None
        if self._guard is not None:
            self._guard.uninstall()
            self._guard = None
        self._opened = False

    def _journal(self, event: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(event, **fields)

    # -- checkpoint routing (Runtime.save) -----------------------------------
    def save(self, path: str, state: Mapping[str, Any]) -> None:
        from sheeprl_tpu_torch.resilience.manifest import checkpoint_step, save_verified_checkpoint

        step = checkpoint_step(path, state)
        if self._writer is not None:
            self._writer.submit(path, state, step=step)
            return
        self._journal("ckpt_begin", path=str(path), step=step, blocking=True, queued_s=0.0)
        try:
            result = save_verified_checkpoint(path, state, step=step)
        except Exception as err:
            # ckpt_begin is never left dangling; a blocking save failure
            # still aborts the run
            self._sync_failed += 1
            self._journal("ckpt_end", path=str(path), step=step, blocking=True, status="failed",
                          error=repr(err)[:200])
            raise
        now = self._clock()
        if self._last_end_t is not None:
            self._last_interval_s = round(max(0.0, now - self._last_end_t), 3)
        self._last_end_t = now
        self._last_step = result["step"]
        self._last_path = result["path"]
        self._sync_written += 1
        self._sync_write_seconds += result["write_ms"] / 1e3
        self._journal("ckpt_end", blocking=True, status="ok", verified=True, **result)

    def flush(self, timeout: Optional[float] = 120.0) -> bool:
        """Wait for every in-flight async write to reach the disk."""
        return self._writer.drain(timeout=timeout) if self._writer is not None else True

    # -- preemption ----------------------------------------------------------
    def preempt_due(self, iter_num: int) -> bool:
        """True once a preemption (a signal, or the injected drill) is
        pending: the loop then forces its checkpoint branch and calls
        ``Diagnostics.on_preempted``."""
        if not self._opened:
            return False
        if self._guard is not None and self._guard.requested:
            self._preempt_reason = f"signal:{self._guard.signal_name}"
            return True
        if self.inject_preempt_iter is not None and int(iter_num) == self.inject_preempt_iter:
            if not self._inject_fired:
                self._inject_fired = True
                self._preempt_reason = "injected"
                self._journal("fault_injection", iter_num=int(iter_num), kind="preempt")
            return True
        return False

    @property
    def preempt_reason(self) -> str:
        return self._preempt_reason or "preempt"

    # -- observability -------------------------------------------------------
    def _ckpt_state(self) -> Dict[str, Any]:
        stats = self._writer.stats() if self._writer is not None else self._writer_final_stats
        if stats is not None:
            return {
                "written": stats["written_total"],
                "failed": stats["failed_total"],
                "write_seconds": stats["write_seconds_total"],
                "last_step": stats["last_step"],
                "last_path": stats["last_path"],
                "last_end_t": stats["last_end_t"],
                "interval_s": stats["last_interval_s"],
            }
        return {
            "written": self._sync_written,
            "failed": self._sync_failed,
            "write_seconds": round(self._sync_write_seconds, 3),
            "last_step": self._last_step,
            "last_path": self._last_path,
            "last_end_t": self._last_end_t,
            "interval_s": self._last_interval_s,
        }

    def snapshot(self) -> Dict[str, Any]:
        state = self._ckpt_state()
        gauges: Dict[str, float] = {}
        if state["last_step"] is not None:
            gauges["Telemetry/ckpt_last_step"] = float(state["last_step"])
        if state["last_end_t"] is not None:
            gauges["Telemetry/ckpt_age_seconds"] = round(max(0.0, time.time() - state["last_end_t"]), 3)
        if state["interval_s"] is not None:
            gauges["Telemetry/ckpt_interval_seconds"] = state["interval_s"]
        counters = {
            "ckpts_written_total": state["written"],
            "ckpt_failures_total": state["failed"],
            "ckpt_write_seconds_total": state["write_seconds"],
            "restarts_total": self._restarts_total,
        }
        return {"gauges": gauges, "counters": counters, "info": {"last_ckpt_path": state["last_path"]}}

    def summary(self) -> Dict[str, Any]:
        """Closing totals merged into the ``telemetry_summary`` event."""
        state = self._ckpt_state()
        return {
            "ckpts_written": state["written"],
            "ckpt_failures": state["failed"],
            "ckpt_write_seconds": state["write_seconds"],
            "restarts": self._restarts_total,
        }
