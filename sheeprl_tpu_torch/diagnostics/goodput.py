"""Run lifecycle and goodput (counterpart of
``sheeprl_tpu/diagnostics/goodput.py``): a run-state machine and a stall
watchdog.

* **Run-state machine**: ``starting -> compiling -> training / env_wait /
  checkpointing / stalled -> ended``, driven by telemetry's dispatch
  notifications, the facade's spans and the metric flushes.  In the port
  ``compiling`` is the ``nvcc`` build of the hand-written kernels at first
  use (``ops/cuda_build.py``; the DreamerV3 loop calls
  :meth:`GoodputMonitor.note_compile_start` before it), and a never-seen
  train-step input signature (eager PyTorch compiles nothing there).
  Transitions are journaled as ``state_change`` (steady states at first
  entry only, stalls always); ``Telemetry/run_state``, ``Telemetry/goodput``
  (train-span seconds over wall seconds since open) and
  ``Telemetry/time_to_first_step`` ride every metric interval.
* **Heartbeat stall watchdog**: a daemon thread wakes every ``heartbeat_s``;
  no progress for ``stall_threshold_s`` journals one fsync'd ``stall`` with
  all-thread stacks, optionally captures a short ``torch.profiler`` trace,
  and journals ``stall_end`` at the next progress signal.
* **Segment accounting**: the journal-side helpers the JAX package's
  ``tools/goodput_report.py`` shares (:func:`stalled_seconds`,
  :func:`journal_run_state`, :func:`segment_stats`).

Journal writes happen outside the monitor's lock, except ``stall`` and
``stall_end``, written while holding it so that ``stall`` always precedes
``stall_end`` on disk.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

#: The run-state vocabulary, in gauge order: ``Telemetry/run_state`` exports
#: the index into this tuple (5 = stalled), so dashboards can alert on it.
STATES: Tuple[str, ...] = (
    "starting",
    "compiling",
    "training",
    "env_wait",
    "checkpointing",
    "stalled",
    "ended",
)
STATE_INDEX: Dict[str, int] = {name: i for i, name in enumerate(STATES)}

#: Facade span names that map onto a run state; unmapped spans (rollout,
#: buffer-sample, custom) count as progress without changing the state.
_SPAN_STATES: Dict[str, str] = {
    "train": "training",
    "env_wait": "env_wait",
    "checkpoint": "checkpointing",
}


def _positive_or_none(value: Any, knob: str) -> Optional[float]:
    """Validate a ``>0-or-null`` watchdog knob (``Event.wait(<=0)`` degenerates
    into a busy-spin, so zero/negative must fail loudly — mirrored in
    ``cli.check_configs`` so the CLI fails before the run dir exists)."""
    if value is None:
        return None
    number = float(value)
    if number <= 0:
        raise ValueError(
            f"diagnostics.goodput.watchdog.{knob} must be > 0 or null "
            f"(null disables the watchdog), got {value!r}"
        )
    return number


class GoodputMonitor:
    """Rank-0 run-state machine + stall watchdog behind the facade.

    Opened by ``Diagnostics.open`` on rank 0 only; every hook is a cheap
    no-op until then, so telemetry and the facade call them unconditionally.
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, cfg: Optional[Mapping[str, Any]], clock: Callable[[], float] = time.monotonic):
        cfg = cfg or {}
        diag_cfg = cfg.get("diagnostics") or {}
        goodput_cfg = diag_cfg.get("goodput") or {}
        self.enabled = bool(goodput_cfg.get("enabled", True))
        wd_cfg = goodput_cfg.get("watchdog") or {}
        self.watchdog_enabled = bool(wd_cfg.get("enabled", True))
        self.heartbeat_s = _positive_or_none(wd_cfg.get("heartbeat_s", 5.0), "heartbeat_s")
        self.stall_threshold_s = _positive_or_none(
            wd_cfg.get("stall_threshold_s", 120.0), "stall_threshold_s"
        )
        inject = wd_cfg.get("inject_stall_iter")
        self.inject_stall_iter = None if inject is None else int(inject)
        # while the state machine says `compiling` the threshold is scaled by
        # this factor (clamped >= 1): a first XLA compile legitimately runs
        # minutes with zero progress signals, and a spurious stall there would
        # dump forensics (and, with the profile pillar on, start a capture)
        # into every cold start — a truly hung compile still trips at
        # threshold x grace
        self.compile_grace = max(1.0, float(wd_cfg.get("compile_grace", 5.0) or 1.0))
        profile_cfg = goodput_cfg.get("profile") or {}
        # matches the YAML default: the profile pillar is OPT-IN (a capture
        # window overlapping the recovering dispatch can wedge the backend
        # profiler), including for direct-entrypoint callers with partial cfgs
        self.profile_enabled = bool(profile_cfg.get("enabled", False))
        # null = the default, NOT zero — check_configs explicitly allows None
        # and the ctor must validate identically
        max_ms = profile_cfg.get("max_ms")
        self.profile_max_ms = 2000.0 if max_ms is None else float(max_ms)
        if self.enabled and self.profile_enabled and self.profile_max_ms < 10:
            # validated only while both are enabled: the remedy the error
            # suggests (disabling the profile pillar) must itself compose
            raise ValueError(
                f"diagnostics.goodput.profile.max_ms must be >= 10 (the capture floor), "
                f"got {profile_cfg.get('max_ms')!r}; set diagnostics.goodput.profile.enabled=False "
                "to disable stall profiling instead"
            )
        self._auto_profiles = int(profile_cfg.get("auto_captures", 1) or 0)

        self._clock = clock
        self._lock = threading.Lock()
        self._profile_lock = threading.Lock()
        self._journal_fn: Optional[Callable[..., None]] = None
        self._sync_fn: Optional[Callable[[], None]] = None
        self._telemetry = None
        self._log_dir: Optional[str] = None
        self._opened = False
        self._closed = False

        self._state: str = "starting"
        self._state_entered_t: Optional[float] = None
        self._state_seconds: Dict[str, float] = {}
        # flood control: steady states journal a state_change at FIRST entry
        # only ("starting" is implicit in run_start, "ended" in run_end)
        self._journaled_states = {"starting", "ended"}
        self._last_progress: Optional[float] = None
        self._open_clock: Optional[float] = None
        self._train_dispatches = 0
        self._time_to_first_step: Optional[float] = None

        self._stalled = False
        self._prestall_state: Optional[str] = None
        self._stall_started_t: Optional[float] = None
        self._stalls_total = 0
        self._stalled_s_total = 0.0
        self._profile_captures = 0

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def open(
        self,
        journal_fn: Optional[Callable[..., None]] = None,
        sync_fn: Optional[Callable[[], None]] = None,
        telemetry: Any = None,
        log_dir: Optional[str] = None,
    ) -> None:
        if self._opened:
            return
        # publish under the monitor lock: the watchdog starts below and reads
        # all of these; the lock (not thread-start ordering) is what makes
        # open() safe to race with an early first heartbeat
        with self._lock:
            self._journal_fn = journal_fn
            self._sync_fn = sync_fn
            self._telemetry = telemetry
            self._log_dir = str(log_dir) if log_dir else None
            now = self._clock()
            self._open_clock = now
            self._state_entered_t = now
            self._last_progress = now
            self._opened = True
        if self.watchdog_enabled and self.heartbeat_s is not None and self.stall_threshold_s is not None:
            self._thread = threading.Thread(
                target=self._watchdog_loop, name="sheeprl-stall-watchdog", daemon=True
            )
            self._thread.start()

    def close(self) -> None:
        """Stop the watchdog and fold the live state tail into the totals.

        Writes NOTHING to the journal (``run_end`` covers the ended
        transition — the facade's close event sequence is pinned by tests);
        an open stall is folded into the stalled-seconds total under the
        lock so ``summary()`` stays honest.
        """
        if not self._opened or self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            now = self._clock()
            if self._stalled:
                self._stalled = False
                if self._stall_started_t is not None:
                    self._stalled_s_total += max(0.0, now - self._stall_started_t)
            self._set_state_locked("ended", now)

    # -- hooks (telemetry + facade; all no-ops until opened) ----------------
    def note_compile_start(self, name: str) -> None:
        """A never-seen dispatch signature is about to compile."""
        if not self._opened:
            return
        self._emit(self._note_progress("compiling"))

    def note_dispatch(self, name: str, kind: str) -> None:
        """An instrumented dispatch completed (called by telemetry after its
        own accounting, outside any lock — the stall injection sleeps here)."""
        if not self._opened:
            return
        if kind != "train":
            self._emit(self._note_progress(None))
            return
        with self._lock:
            self._train_dispatches += 1
            n = self._train_dispatches
            if self._time_to_first_step is None and self._open_clock is not None:
                self._time_to_first_step = max(0.0, self._clock() - self._open_clock)
        self._emit(self._note_progress("training"))
        if (
            self.inject_stall_iter is not None
            and n == self.inject_stall_iter
            and self.stall_threshold_s is not None
            and self.heartbeat_s is not None
        ):
            # fault drill: hold the loop thread idle long enough for the
            # watchdog to fire, then recover deterministically — exactly one
            # stall + stall_end per run
            sleep_s = self.stall_threshold_s + 4.0 * self.heartbeat_s
            self._journal("fault_injection", iter_num=n, kind="stall", sleep_s=round(sleep_s, 3))
            time.sleep(sleep_s)
            self._emit(self._note_progress("training"))

    def note_span(self, name: str) -> None:
        """Facade span enter: progress, plus a state change for mapped names
        (train / env_wait / checkpoint)."""
        if not self._opened:
            return
        self._emit(self._note_progress(_SPAN_STATES.get(name)))

    # -- state machine core -------------------------------------------------
    def _note_progress(self, new_state: Optional[str]) -> Optional[Dict[str, Any]]:
        """Record a progress signal; returns a ``state_change`` payload to be
        journaled OUTSIDE the lock (or None).  Stall recovery journals
        ``stall_end`` (and its state_change, when due) while HOLDING the lock
        so it can never land on disk before the watchdog's ``stall``."""
        with self._lock:
            now = self._clock()
            self._last_progress = now
            if self._stalled:
                self._stalled = False
                stalled_for = 0.0
                if self._stall_started_t is not None:
                    stalled_for = max(0.0, now - self._stall_started_t)
                self._stalled_s_total += stalled_for
                self._stall_started_t = None
                # a site that does not set its own state restores the one the
                # stall interrupted — every recovery path leaves `stalled`
                target = new_state or self._prestall_state or "training"
                self._prestall_state = None
                payload = self._set_state_locked(target, now)
                if payload is not None:
                    self._journal("state_change", **payload)
                self._journal("stall_end", state=target, stalled_s=round(stalled_for, 3))
                return None
            if new_state is not None:
                return self._set_state_locked(new_state, now)
        return None

    def _set_state_locked(self, state: str, now: float) -> Optional[Dict[str, Any]]:
        """Transition (caller holds the lock); returns the journal payload
        when flood control says this transition is journal-worthy."""
        prev = self._state
        if prev == state:
            return None
        if self._state_entered_t is not None:
            self._state_seconds[prev] = self._state_seconds.get(prev, 0.0) + max(
                0.0, now - self._state_entered_t
            )
        self._state = state
        self._state_entered_t = now
        if state == "stalled":
            return {"state": state, "prev": prev}
        first_entry = state not in self._journaled_states
        self._journaled_states.add(state)
        return {"state": state, "prev": prev} if first_entry else None

    def _emit(self, payload: Optional[Dict[str, Any]]) -> None:
        if payload is not None:
            self._journal("state_change", **payload)

    def _journal(self, event: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(event, **fields)

    # -- watchdog ------------------------------------------------------------
    def _watchdog_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            with self._lock:
                if self._stalled or self._last_progress is None:
                    continue
                baseline = self._last_progress
                idle = self._clock() - baseline
                threshold = self._stall_threshold_locked()
            if idle >= threshold:
                # the abort baseline is the progress reading the idle math
                # used: progress landing between this check and the stall
                # lock must still abort the stall
                self._mark_stalled(idle, threshold_s=threshold, progress_seen=baseline)

    def _stall_threshold_locked(self) -> float:
        """Effective stall threshold for the CURRENT position (caller holds
        the lock): scaled by ``compile_grace`` while compiling — and until
        the first train dispatch completes, which covers the agent-build/env
        setup window AND the telemetry-off configuration (no dispatch
        notifications there means `compiling` is unreachable and
        ``_train_dispatches`` stays 0, so the watchdog permanently runs at
        the conservative threshold x grace instead of false-flagging every
        long first compile)."""
        grace = (
            self.compile_grace
            if (self._state == "compiling" or self._train_dispatches == 0)
            else 1.0
        )
        return self.stall_threshold_s * grace

    def _mark_stalled(
        self,
        idle_s: float,
        threshold_s: Optional[float] = None,
        progress_seen: Optional[float] = None,
    ) -> None:
        """Journal exactly one fsync'd ``stall`` with forensics.

        ``threshold_s`` is the EFFECTIVE threshold that tripped (the watchdog
        passes the compile-grace-scaled value so the forensics never look
        like a late firing); defaults to the base threshold for direct calls.
        ``progress_seen`` is the ``_last_progress`` reading the caller's idle
        computation used — any progress after THAT aborts the stall.

        Stack gathering happens UNFLAGGED and lock-free (it takes tens of
        ms); the lock is then re-taken and the stall aborted if progress
        landed meanwhile.  ``state_change``+``stall`` are written while
        HOLDING the lock — the one exception to the journal-outside-the-lock
        rule — so ``stall`` always precedes ``stall_end`` on disk.
        """
        if progress_seen is None:
            with self._lock:
                progress_seen = self._last_progress
        stacks = self._thread_stacks()
        with self._lock:
            if self._stalled or self._last_progress != progress_seen:
                return  # progress (or another stall) won the race
            now = self._clock()
            self._stalled = True
            self._stalls_total += 1
            self._prestall_state = self._state
            # stalled time is DETECTION -> recovery on every surface (live
            # counter, state_seconds, journal stall->stall_end bounds); the
            # idle lead-in before detection is the stall event's idle_s
            self._stall_started_t = now
            payload = self._set_state_locked("stalled", now)
            if payload is not None:
                self._journal("state_change", **payload)
            self._journal(
                "stall",
                idle_s=round(float(idle_s), 3),
                threshold_s=threshold_s if threshold_s is not None else self.stall_threshold_s,
                last_state=self._prestall_state,
                stacks=stacks,
            )
            if self._sync_fn is not None:
                self._sync_fn()  # the record must survive a SIGKILL right now
        if not self.profile_enabled:
            return
        with self._lock:
            if self._auto_profiles <= 0:
                return
            self._auto_profiles -= 1

        def _auto_capture() -> None:
            result = self.capture_profile()
            if (result or {}).get("status") == "busy":
                with self._lock:
                    self._auto_profiles += 1  # refund: nothing was captured

        # its own daemon thread: a capture that wedges in the backend
        # profiler (seen when the recovering dispatch overlaps the
        # capture window) must cost the run one thread, not the watchdog
        # or a hang in close()
        threading.Thread(
            target=_auto_capture, name="sheeprl-stall-profile", daemon=True
        ).start()

    def _thread_stacks(self, limit: int = 12000) -> str:
        """All-thread stacks via ``faulthandler`` (needs a real fd).  Tail
        truncation is correct: faulthandler prints the current (watchdog)
        thread FIRST and the main thread LAST — verified empirically, so the
        stuck loop thread survives the cut."""
        import faulthandler
        import tempfile

        try:
            with tempfile.TemporaryFile(mode="w+") as fp:
                faulthandler.dump_traceback(file=fp, all_threads=True)
                fp.seek(0)
                text = fp.read()
        except Exception as err:  # pragma: no cover - exotic platforms
            return f"<stack capture failed: {err!r}>"
        return text[-limit:]

    # -- profiler capture (auto on stall + the /profile endpoint) ------------
    def capture_profile(self, ms: Optional[float] = None) -> Dict[str, Any]:
        """Capture a short ``torch.profiler`` trace under the run dir.

        Returns (and journals as ``profile_capture``) a status dict — always
        a dict, never raises: ``ok`` with the output dir, ``busy`` when a
        capture is already running (including ``metric.profiler``'s whole-run
        trace holding the profiler), or ``failed`` with the error.  ``ms``
        defaults to ``profile.max_ms`` and is clamped into [10, max_ms]
        (``ms=0`` clamps to the 10 ms floor, not the default).
        """
        if not self._opened or not self.profile_enabled:
            return {"status": "disabled"}
        duration_ms = float(ms) if ms is not None else self.profile_max_ms
        duration_ms = min(max(10.0, duration_ms), self.profile_max_ms)
        if not self._profile_lock.acquire(blocking=False):
            result: Dict[str, Any] = {"status": "busy"}
            self._journal("profile_capture", **result)
            return result
        try:
            out_dir = os.path.join(self._log_dir or ".", "goodput_profile")
            os.makedirs(out_dir, exist_ok=True)
            try:
                import torch

                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                # a profiler already running (metric.profiler's whole-run
                # trace) makes start raise: never fatal, and nothing to stop
                prof.start()
            except Exception as err:
                result = {"status": "failed", "error": repr(err)[:200]}
            else:
                try:
                    time.sleep(duration_ms / 1000.0)
                    prof.stop()
                    path = os.path.join(out_dir, f"profile_{int(time.time() * 1000)}.json")
                    prof.export_chrome_trace(path)
                    with self._lock:
                        self._profile_captures += 1
                    result = {"status": "ok", "dir": out_dir, "ms": round(duration_ms, 1)}
                except Exception as err:
                    try:
                        prof.stop()  # our session is the active one here
                    except Exception:
                        pass
                    result = {"status": "failed", "error": repr(err)[:200]}
        finally:
            self._profile_lock.release()
        self._journal("profile_capture", **result)
        return result

    # -- gauges / snapshots --------------------------------------------------
    def _train_seconds(self) -> Optional[float]:
        """Goodput's numerator: telemetry's exact train-span seconds, or None
        when no telemetry is attached (the gauge is then OMITTED — a false
        0.0 would read as 'zero productive time')."""
        telemetry = self._telemetry
        if telemetry is None:
            return None
        try:
            return float(telemetry.train_seconds())
        except Exception:  # pragma: no cover - foreign telemetry stand-ins
            return None

    def _lifecycle_gauges(self) -> Dict[str, float]:
        """The gauge triple shared by :meth:`interval_metrics` (journal/TB)
        and :meth:`snapshot` (/metrics) — ONE site owns the omission rules
        (goodput/ttfs only with telemetry attached, never a false 0.0)."""
        with self._lock:
            out: Dict[str, float] = {"Telemetry/run_state": float(STATE_INDEX[self._state])}
            ttfs = self._time_to_first_step
            open_clock = self._open_clock
        train_s = self._train_seconds()
        if train_s is not None:
            if open_clock is not None:
                elapsed = self._clock() - open_clock
                if elapsed > 0:
                    out["Telemetry/goodput"] = train_s / elapsed
            if ttfs is not None:
                out["Telemetry/time_to_first_step"] = round(ttfs, 3)
        return out

    def interval_metrics(self) -> Dict[str, float]:
        """Per-interval gauges merged into the metric stream by the facade;
        the flush itself is a progress signal (prevents spurious stalls while
        a run tears down between the last dispatch and close)."""
        if not self._opened:
            return {}
        self._emit(self._note_progress(None))
        return self._lifecycle_gauges()

    def snapshot(self) -> Dict[str, Any]:
        gauges = self._lifecycle_gauges()
        with self._lock:
            counters = {
                "stalls_total": self._stalls_total,
                "stalled_seconds_total": round(self._stalled_s_total, 3),
                "profile_captures_total": self._profile_captures,
            }
            info = {"run_state": self._state}
        return {"gauges": gauges, "counters": counters, "info": info}

    def summary(self) -> Dict[str, Any]:
        """Run totals merged into the closing ``telemetry_summary`` event
        (call after :meth:`close` so the live state tail is folded in)."""
        with self._lock:
            out: Dict[str, Any] = {
                "state_seconds": {k: round(v, 3) for k, v in sorted(self._state_seconds.items())},
                "stalls": self._stalls_total,
                "stalled_seconds": round(self._stalled_s_total, 3),
                "profile_captures": self._profile_captures,
            }
            if self._time_to_first_step is not None:
                out["time_to_first_step_s"] = round(self._time_to_first_step, 3)
            open_clock = self._open_clock
            end_clock = self._state_entered_t if self._state == "ended" else self._clock()
        train_s = self._train_seconds()
        if train_s is not None and open_clock is not None and end_clock is not None:
            elapsed = max(0.0, end_clock - open_clock)
            if elapsed > 0:
                out["goodput"] = round(train_s / elapsed, 4)
        return out


# ---------------------------------------------------------------------------
# journal-side accounting (shared by report.py status lines, goodput_report
# and the trace_report run-state overlay — do NOT re-inline this math)


def stalled_seconds(events: List[Dict[str, Any]]) -> float:
    """Seconds stalled according to a journal event list: closed stalls sum
    their ``stall → stall_end`` bounds; an unclosed stall (killed while
    stalled) contributes ``stall →`` *last journal event* seconds — the best
    journal-only estimate, since the actual death time is unknowable
    post-hoc."""
    total = 0.0
    open_t: Optional[float] = None
    last_t: Optional[float] = None
    for event in events:
        t = event.get("t")
        if not isinstance(t, (int, float)):
            continue
        last_t = t if last_t is None else max(last_t, t)
        kind = event.get("event")
        if kind == "stall":
            open_t = t
        elif kind == "stall_end" and open_t is not None:
            total += max(0.0, t - open_t)
            open_t = None
    if open_t is not None and last_t is not None:
        total += max(0.0, last_t - open_t)
    return total


def journal_run_state(events: List[Dict[str, Any]]) -> Optional[Tuple[float, str]]:
    """Freshest known run state ``(t, state)`` from a journal.

    Flood control journals steady ``state_change`` events only at FIRST
    entry, so the per-interval ``Telemetry/run_state`` gauge must be read
    too — the newest of gauge / state_change / stall / stall_end / run_end
    wins."""
    best: Optional[Tuple[float, str]] = None
    for event in events:
        t = event.get("t")
        if not isinstance(t, (int, float)):
            continue
        kind = event.get("event")
        state: Optional[str] = None
        if kind == "state_change":
            state = event.get("state")
        elif kind == "stall":
            state = "stalled"
        elif kind == "stall_end":
            state = event.get("state") or "training"
        elif kind == "run_end":
            state = "ended"
        elif kind == "metrics":
            gauge = (event.get("metrics") or {}).get("Telemetry/run_state")
            if isinstance(gauge, (int, float)) and 0 <= int(gauge) < len(STATES):
                state = STATES[int(gauge)]
        if state is not None and (best is None or t >= best[0]):
            best = (t, str(state))
    return best


def segment_stats(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-segment accounting over one journal's event list.

    Productive (train) seconds come from the closing ``telemetry_summary``
    when the segment shut down cleanly; a killed segment recovers them from
    its last journaled cumulative ``Telemetry/goodput`` gauge
    (``gauge * seconds-since-run_start`` — the gauge is cumulative-since-open
    by contract)."""
    ts = [e.get("t") for e in events if isinstance(e.get("t"), (int, float))]
    start_t = min(ts) if ts else None
    end_t = max(ts) if ts else None
    run_end = next((e for e in reversed(events) if e.get("event") == "run_end"), None)
    summary = next((e for e in reversed(events) if e.get("event") == "telemetry_summary"), None)
    metrics_events = [e for e in events if e.get("event") == "metrics"]

    train_s: Optional[float] = None
    source: Optional[str] = None
    ttfs: Optional[float] = None
    if summary is not None:
        phase = summary.get("phase_seconds") or {}
        if isinstance(phase.get("train"), (int, float)):
            train_s = float(phase["train"])
            source = "summary"
        if isinstance(summary.get("time_to_first_step_s"), (int, float)):
            ttfs = float(summary["time_to_first_step_s"])
    if train_s is None and start_t is not None:
        for event in reversed(metrics_events):
            gauge = (event.get("metrics") or {}).get("Telemetry/goodput")
            if isinstance(gauge, (int, float)) and isinstance(event.get("t"), (int, float)):
                train_s = float(gauge) * max(0.0, event["t"] - start_t)
                source = "gauge"
                break
    if ttfs is None:
        for event in reversed(metrics_events):
            value = (event.get("metrics") or {}).get("Telemetry/time_to_first_step")
            if isinstance(value, (int, float)):
                ttfs = float(value)
                break

    last_step = None
    for event in reversed(metrics_events):
        if event.get("step") is not None:
            last_step = event["step"]
            break

    wall_s = max(0.0, (end_t or 0.0) - (start_t or 0.0)) if ts else 0.0
    return {
        "start_t": start_t,
        "end_t": end_t,
        "wall_s": round(wall_s, 3),
        "status": run_end.get("status") if run_end is not None else None,
        "train_s": round(train_s, 3) if train_s is not None else None,
        "train_source": source,
        "goodput": round(train_s / wall_s, 4) if train_s is not None and wall_s > 0 else None,
        "stalls": sum(1 for e in events if e.get("event") == "stall"),
        "stalled_s": round(stalled_seconds(events), 3),
        # only successful captures count (matches the live counter)
        "profile_captures": sum(
            1 for e in events if e.get("event") == "profile_capture" and e.get("status") == "ok"
        ),
        "time_to_first_step_s": ttfs,
        "last_step": last_step,
        "state_seconds": (summary or {}).get("state_seconds"),
    }
