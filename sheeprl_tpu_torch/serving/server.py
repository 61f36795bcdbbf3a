"""The policy server: batched inference and health-gated checkpoint hot
reload behind a stdlib HTTP tier (counterpart of
``sheeprl_tpu/serving/server.py``).

Cooperating pieces, one process:

* :class:`PolicyService` — owns one model's modules (hot-swappable under a
  lock), one eager step per ``(bucket, greedy)`` signature and the dispatch
  the batcher drives: assemble the padded batch, take the modules' reference
  ONCE, move the batch to the device, run the step, slice the valid rows.
  ``promote`` swaps the reference to freshly built modules between
  dispatches; a checkpoint whose ``state_dict`` differs in keys, shapes or
  dtypes is rejected, never half-installed.  For a stateful policy
  (DreamerV3, PPO-recurrent) the step gathers the sessions' state from the
  device slab and scatters it back (:mod:`~sheeprl_tpu_torch.serving.sessions`);
* :class:`ServeApp` — ``ThreadingHTTPServer`` serving ``POST /act``, ``GET
  /metrics`` (Prometheus text, the ``sheeprl_serve_*`` /
  ``sheeprl_sessions_*`` families) and ``GET /healthz`` with the JAX
  server's wire format, so one client talks to either server.  It holds a
  :class:`~sheeprl_tpu_torch.serving.registry.ModelRegistry` of N resident
  models: ``/act`` routes on the request's ``model`` field, each model has
  its own service, watcher and request log;
* :class:`CheckpointWatcher` — polls a training run's checkpoint directory
  per model, gates every new checkpoint on that run's journal
  (:func:`~sheeprl_tpu_torch.serving.loader.checkpoint_health`) and journals
  the verdict as ``ckpt_promote`` / ``ckpt_reject`` in the serving run's own
  journal (``logs/serve/<run_name>/version_N``), next to
  ``trace_serve.json``;
* the request log — with ``serving.request_log.enabled`` every dispatched
  batch is appended to a per-model offline dataset stream
  (:class:`~sheeprl_tpu_torch.serving.request_log.RequestLog`).

A promotion builds the new modules on the watcher thread, on the service's
device, and waits for their copies before the swap; the dispatch holds the
old reference until its batch is done, so the old copy is freed after the
last in-flight dispatch on it.  Sessions survive a promotion.

Randomness comes from ``torch.Generator``s on the device.  A greedy dispatch
re-seeds its generator to 0, the counterpart of the JAX server's
``jax.random.PRNGKey(0)``: the same semantics (the posterior is still
sampled, from a fixed stream), not the same bits.  A stochastic dispatch
draws from a second generator seeded from the clock once.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.diagnostics.journal import JOURNAL_NAME, RunJournal
from sheeprl_tpu_torch.diagnostics.metrics_server import (
    PROMETHEUS_CONTENT_TYPE,
    latency_histogram_lines,
    render_prometheus,
)
from sheeprl_tpu_torch.diagnostics.tracing import TRACE_SERVE_NAME, NullTracer, PhaseTracer
from sheeprl_tpu_torch.serving.batcher import DEFAULT_BUCKETS, DynamicBatcher, ServeError, _percentile, pick_bucket
from sheeprl_tpu_torch.serving.loader import (
    PolicyHandle,
    agent_state_from_checkpoint,
    checkpoint_health,
    checkpoint_step,
    latest_checkpoint,
    load_policy,
)
from sheeprl_tpu_torch.serving.registry import ModelEntry, ModelRegistry, render_registry_metrics
from sheeprl_tpu_torch.serving.request_log import RequestLog
from sheeprl_tpu_torch.serving.sessions import SessionStore, make_slab_step

SERVE_GAUGE_PREFIX = "Telemetry/serve/"
SESSIONS_GAUGE_PREFIX = "Telemetry/sessions/"

#: fallback when ``serving.slo.buckets_ms`` is absent
#: (``configs/serving/default.yaml`` mirrors this)
DEFAULT_SLO_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)

#: what a checkpoint file the watcher cannot use raises: unreadable,
#: truncated, or a tree the converter refuses (another shape, a missing key,
#: another dtype).  Anything else (a CUDA error among them) stops the watcher.
BAD_CHECKPOINT_ERRORS = (OSError, EOFError, pickle.UnpicklingError, KeyError, TypeError, ValueError)


class PhaseStats:
    """Per-phase latency accounting for one model: rolling p50/p99 windows
    for the live gauges plus cumulative Prometheus histogram counts
    (``sheeprl_serve_latency_ms_bucket{phase,le}``) with the fixed bucket
    bounds of ``serving.slo.buckets_ms``, so series from different scrapes
    and models stay mergeable."""

    PHASES = ("queue", "batch_form", "dispatch", "scatter", "total")

    def __init__(self, buckets_ms: Any = None):
        self.buckets_ms = tuple(float(b) for b in (buckets_ms or DEFAULT_SLO_BUCKETS_MS))
        if list(self.buckets_ms) != sorted(self.buckets_ms):
            raise ValueError(f"serving.slo.buckets_ms must be ascending, got {list(self.buckets_ms)}")
        self._lock = threading.Lock()
        self._window: Dict[str, deque] = {p: deque(maxlen=1024) for p in self.PHASES}
        # per-bin (non-cumulative) counts; the last bin is +Inf
        self._bins: Dict[str, List[int]] = {p: [0] * (len(self.buckets_ms) + 1) for p in self.PHASES}
        self._sum: Dict[str, float] = {p: 0.0 for p in self.PHASES}
        self._count: Dict[str, int] = {p: 0 for p in self.PHASES}

    def observe(self, phase: str, value_ms: float) -> None:
        value = max(0.0, float(value_ms))
        bin_i = len(self.buckets_ms)
        for i, le in enumerate(self.buckets_ms):
            if value <= le:
                bin_i = i
                break
        with self._lock:
            self._window[phase].append(value)
            self._bins[phase][bin_i] += 1
            self._sum[phase] += value
            self._count[phase] += 1

    def percentiles(self) -> Dict[str, Tuple[float, float]]:
        """``{phase: (p50_ms, p99_ms)}`` over the rolling window (phases with
        no observation yet are omitted)."""
        with self._lock:
            windows = {p: sorted(w) for p, w in self._window.items() if w}
        return {phase: (round(_percentile(values, 50.0), 3), round(_percentile(values, 99.0), 3))
                for phase, values in windows.items()}

    def histogram(self) -> Dict[str, Dict[str, Any]]:
        """``{phase: {"buckets": [(le, cum_count), ..., ("+Inf", total)],
        "sum": ms, "count": n}}``: the Prometheus histogram's shape."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for phase in self.PHASES:
                if not self._count[phase]:
                    continue
                cum = 0
                buckets: List[Tuple[Any, int]] = []
                for le, n in zip(self.buckets_ms, self._bins[phase]):
                    cum += n
                    buckets.append((le, cum))
                cum += self._bins[phase][-1]
                buckets.append(("+Inf", cum))
                out[phase] = {"buckets": buckets, "sum": round(self._sum[phase], 3), "count": self._count[phase]}
        return out


class SloMonitor:
    """Rolling-window latency SLO: burn rate and flood-controlled breach
    journaling.

    Every completed request is classified against ``target_ms``; the burn
    rate is ``bad_fraction / (1 - objective)`` over the last ``window``
    requests (above 1.0 the error budget is spent faster than the objective
    allows).  ``confirm`` consecutive burn > 1 observations journal ONE
    fsync'd ``slo_breach``, recovery journals ``slo_breach_end``, and nothing
    repeats while the breach is active."""

    def __init__(
        self,
        target_ms: Optional[float] = None,
        objective: float = 0.99,
        window: int = 256,
        confirm: int = 8,
        journal: Any = None,
        model: Optional[str] = None,
    ):
        self.target_ms = None if target_ms is None else float(target_ms)
        self.objective = min(0.99999, max(0.0, float(objective)))
        self._journal = journal
        self.model = model
        self._window: deque = deque(maxlen=max(1, int(window)))
        self._confirm = max(1, int(confirm))
        self._lock = threading.Lock()
        self._breaches = 0
        self.active = False
        self.breaches_total = 0
        self.burn = 0.0
        self._active_since_t: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.target_ms is not None

    def observe(self, total_ms: float) -> float:
        if self.target_ms is None:
            return 0.0
        # transitions are decided under the lock; the journal write (and its
        # fsync) happens after release, since snapshot() and /healthz contend
        # for the lock.  One caller per monitor keeps breach -> breach_end in
        # order on disk.
        breach = None
        breach_end = None
        with self._lock:
            self._window.append(float(total_ms) > self.target_ms)
            budget = max(1e-9, 1.0 - self.objective)
            self.burn = (sum(self._window) / len(self._window)) / budget
            burn = self.burn
            if burn > 1.0:
                self._breaches += 1
                if self._breaches >= self._confirm and not self.active:
                    self.active = True
                    self.breaches_total += 1
                    self._active_since_t = time.time()
                    breach = {
                        "model": self.model,
                        "burn": round(burn, 4),
                        "target_ms": self.target_ms,
                        "objective": self.objective,
                        "window": len(self._window),
                        "confirm": self._confirm,
                    }
            else:
                self._breaches = 0
                if self.active:
                    self.active = False
                    since = self._active_since_t
                    self._active_since_t = None
                    breach_end = {
                        "model": self.model,
                        "burn": round(burn, 4),
                        "breach_s": None if since is None else round(time.time() - since, 3),
                    }
        if self._journal is not None:
            if breach is not None:
                self._journal.write("slo_breach", **breach)
                self._journal.sync()
            if breach_end is not None:
                self._journal.write("slo_breach_end", **breach_end)
        return burn


def params_state(params: Any) -> Dict[str, torch.Tensor]:
    """A served ``params`` (a module, or a name -> module dict) as one flat
    ``state_dict`` with ``<name>.`` prefixes."""
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    if isinstance(params, Mapping):
        return {f"{name}.{key}": value for name in sorted(params) for key, value in params_state(params[name]).items()}
    raise TypeError(f"served params must be a module or a mapping of modules, got {type(params).__name__}")


class PolicyService:
    """Batched inference over one hot-swappable set of modules.  Stateful
    handles get a :class:`SessionStore`: each step gathers the batch's session
    rows from the device slab and scatters the new state back in place;
    stateless ones run the handle's ``make_step`` on the padded batch."""

    def __init__(
        self,
        handle: PolicyHandle,
        serving_cfg: Optional[Mapping[str, Any]] = None,
        journal: Any = None,
        model: Optional[str] = None,
        tracer: Any = None,
        inject_slow_iter: Optional[int] = None,
    ):
        cfg = dict(serving_cfg or {})
        self.handle = handle
        self.device = handle.device
        self._journal = journal
        self.model = model
        self._tracer = tracer if tracer is not None else NullTracer()
        self.default_greedy = bool(cfg.get("greedy", True))
        self.buckets = tuple(sorted(int(b) for b in (cfg.get("batch_buckets") or list(DEFAULT_BUCKETS))))
        # the batcher reports every completed request's phases back through
        # _on_request_done: the histograms, the SLO and slow-request forensics
        slo_cfg = dict(cfg.get("slo") or {})
        self.phase_stats = PhaseStats(slo_cfg.get("buckets_ms"))
        self.slo = SloMonitor(
            target_ms=slo_cfg.get("target_ms"),
            objective=float(slo_cfg.get("objective", 0.99)),
            window=int(slo_cfg.get("window", 256)),
            confirm=int(slo_cfg.get("confirm", 8)),
            journal=journal,
            model=model,
        )
        self.slow_trace_ms = None if slo_cfg.get("slow_trace_ms") is None else float(slo_cfg["slow_trace_ms"])
        self.slow_requests_total = 0
        self.last_slow_request_id: Optional[str] = None
        self._inject_slow_iter = None if inject_slow_iter is None else int(inject_slow_iter)
        if self._inject_slow_iter is not None and self.slow_trace_ms is None:
            # a drill that can never journal its slow_request is a config
            # error, not a silent no-op
            raise ValueError(
                "diagnostics.serving.inject_slow_iter requires serving.slo.slow_trace_ms "
                "to be set; the drill exists to fire the slow_request path"
            )
        self.batcher = DynamicBatcher(
            self._dispatch,
            buckets=self.buckets,
            max_delay_ms=float(cfg.get("max_delay_ms", 5.0)),
            max_queue=int(cfg.get("max_queue", 4096)),
            tracer=self._tracer,
            on_request_done=self._on_request_done,
        )
        self.sessions: Optional[SessionStore] = None
        if handle.stateful:
            sessions_cfg = dict(cfg.get("sessions") or {})
            self.sessions = SessionStore(handle.state_spec, int(sessions_cfg.get("capacity", 64)), device=self.device,
                                         journal=journal, model=model, tracer=self._tracer)
        # set by ServeApp with serving.request_log.enabled; the dispatch
        # appends every valid row after slicing off the padding
        self.request_log: Optional[RequestLog] = None
        self._params_lock = threading.Lock()
        self._params = handle.params
        self._params_version = 0
        self.ckpt_step = int(handle.ckpt_step)
        self.ckpt_path = str(handle.ckpt_path)
        # the batcher thread builds a width's step at its first dispatch,
        # warmup() on the caller's thread: one builder at a time
        self._steps_lock = threading.Lock()
        self._steps: Dict[Tuple[int, bool], Callable] = {}
        self._greedy_gen = torch.Generator(device=self.device)
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(time.time_ns() % (2**31))
        # the counters and self.info change on the watcher thread (promote,
        # reject) and the batcher's callback while snapshot() reads them from
        # HTTP threads: one leaf lock, never held across a dispatch or a write
        self._stats_lock = threading.Lock()
        self.promotions_total = 0
        self.rejections_total = 0
        self.last_promote_rejected = False
        self._dispatch_counter = 0
        self.warmup_steps = 0
        # test seam: a sleep per dispatch AFTER the params snapshot, so a
        # promotion can land deterministically during an in-flight batch
        self._step_delay_s: Optional[float] = None
        self.info: Dict[str, Any] = {"algo": handle.algo, "role": "serve", "ckpt_path": self.ckpt_path or None,
                                     "model": model}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "PolicyService":
        self.batcher.start()
        return self

    def warmup(self) -> None:
        """Run every (bucket, mode) step once on the scratch slot, so the
        first requests pay no one-time costs (cuDNN algorithm choice, the
        kernel build and load)."""
        with self._params_lock:
            params = self._params
        for bucket in self.buckets:
            for greedy in (True, False):
                obs = self._to_device(self.handle.zero_obs(bucket))
                if self.sessions is None:
                    self._step(bucket, greedy)(params, obs, self._generator(greedy))
                else:
                    idx = torch.full((bucket,), self.sessions.scratch, dtype=torch.int64, device=self.device)
                    is_first = torch.ones((bucket, 1), dtype=torch.float32, device=self.device)
                    self._step(bucket, greedy)(params, self.sessions.slab, idx, obs, is_first,
                                               self._generator(greedy))
                self.warmup_steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        self.batcher.close()
        if self.request_log is not None:
            request_log, self.request_log = self.request_log, None
            request_log.close()

    # -- the step ----------------------------------------------------------
    def _step(self, width: int, greedy: bool) -> Callable:
        key = (int(width), bool(greedy))
        with self._steps_lock:
            if key not in self._steps:
                self._steps[key] = (self.handle.make_step(bool(greedy)) if self.sessions is None
                                    else make_slab_step(self.handle.make_state_step(bool(greedy))))
            return self._steps[key]

    def _generator(self, greedy: bool) -> torch.Generator:
        if greedy:
            return self._greedy_gen.manual_seed(0)
        return self._sample_gen

    def _to_device(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in obs.items()}

    # -- dispatch (called from the batcher thread) -------------------------
    def _maybe_inject_slow(self) -> None:
        """``diagnostics.serving.inject_slow_iter`` fault drill: the Nth
        dispatch sleeps well past ``slo.slow_trace_ms``, so the slow_request
        -> slo_breach -> slo_breach_end chain fires through the real request
        path (journaled like every injected fault)."""
        if self._inject_slow_iter is None or self._dispatch_counter != self._inject_slow_iter:
            return
        delay_s = max(0.05, 2.0 * float(self.slow_trace_ms or 0.0) / 1000.0)
        if self._journal is not None:
            self._journal.write("fault_injection", kind="slow_dispatch", model=self.model,
                                dispatch_id=self._dispatch_counter, delay_s=round(delay_s, 3))
        time.sleep(delay_s)

    def _snapshot_params(self) -> Tuple[Any, int, int]:
        """ONE reference per dispatch: a concurrent promote() swaps it for
        the NEXT dispatch, this batch runs on the modules it took."""
        with self._params_lock:
            return self._params, self._params_version, self.ckpt_step

    def _dispatch(self, rows: List[Dict[str, Any]], greedy: bool) -> Tuple[Any, Dict[str, Any]]:
        width = pick_bucket(len(rows), self.buckets)
        if self.sessions is not None:
            return self._dispatch_stateful(rows, greedy, width)
        obs = self._to_device(self.handle.assemble(rows, width))
        params, version, step = self._snapshot_params()
        if self._step_delay_s:
            time.sleep(self._step_delay_s)
        self._dispatch_counter += 1
        self._maybe_inject_slow()
        out = self._step(width, greedy)(params, obs, self._generator(greedy)).cpu().numpy()
        meta = {"ckpt_step": step, "params_version": version, "batch_width": width, "batch_rows": len(rows),
                "dispatch_id": self._dispatch_counter}
        valid = out[: len(rows)]
        if self.request_log is not None:
            self.request_log.append(rows, valid)
        return valid, meta

    def _dispatch_stateful(self, rows: List[Dict[str, Any]], greedy: bool, width: int) -> Tuple[Any, Dict[str, Any]]:
        """One stateful dispatch: resolve each row's slab slot (LRU checkout,
        journaling any eviction), then gather/step/scatter.  Padding and
        sessionless rows ride the scratch slot with ``is_first`` forced to 1."""
        obs_rows = [r["obs"] for r in rows]
        obs = self._to_device(self.handle.assemble(obs_rows, width))
        params, version, step = self._snapshot_params()
        if self._step_delay_s:
            time.sleep(self._step_delay_s)
        self._dispatch_counter += 1
        self._maybe_inject_slow()
        idx, is_first, evicted = self.sessions.checkout(
            [r.get("session") for r in rows], [bool(r.get("reset")) for r in rows], width
        )
        actions = self._step(width, greedy)(
            params,
            self.sessions.slab,
            torch.from_numpy(idx).to(self.device),
            obs,
            torch.from_numpy(is_first).to(self.device),
            self._generator(greedy),
        )
        out = actions.cpu().numpy()
        meta = {
            "ckpt_step": step,
            "params_version": version,
            "batch_width": width,
            "batch_rows": len(rows),
            "dispatch_id": self._dispatch_counter,
            "sessions_active": self.sessions.active,
            "session_evictions": len(evicted),
        }
        valid = out[: len(rows)]
        if self.request_log is not None:
            self.request_log.append(obs_rows, valid, is_first[: len(rows)])
        return valid, meta

    # -- request entry (called from HTTP handler threads) ------------------
    def act(
        self,
        obs: Any,
        greedy: Optional[bool] = None,
        timeout_s: float = 30.0,
        session: Optional[str] = None,
        reset: bool = False,
        request_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        row = self.handle.validate(obs)
        use_greedy = self.default_greedy if greedy is None else bool(greedy)
        if self.sessions is None:
            if session is not None:
                raise ServeError(400, f"algorithm {self.handle.algo!r} serves statelessly; 'session' is only valid "
                                      "for recurrent/model-based policies")
            return self.batcher.submit(row, use_greedy, timeout_s=timeout_s, request_id=request_id)
        sid = None if session is None else str(session)
        # a non-None group key keeps one session's rows out of the same
        # dispatch: its slab slot is gathered at most once per batch
        return self.batcher.submit(
            {"obs": row, "session": sid, "reset": bool(reset)},
            use_greedy,
            timeout_s=timeout_s,
            group_key=None if sid is None else ("session", sid),
            request_id=request_id,
        )

    # -- latency / SLO accounting (called from the batcher thread) ---------
    def _on_request_done(self, done: Dict[str, Any]) -> None:
        """Per completed request: feed the phase histograms and the SLO burn
        window and, past ``slo.slow_trace_ms``, journal one fsync'd
        ``slow_request`` with the full breakdown."""
        phases = dict(done.get("phases") or {})
        total_ms = float(done.get("total_ms") or 0.0)
        self.phase_stats.observe("queue", phases.get("queue_ms", 0.0))
        self.phase_stats.observe("batch_form", phases.get("batch_form_ms", 0.0))
        self.phase_stats.observe("dispatch", phases.get("dispatch_ms", 0.0))
        self.phase_stats.observe("scatter", phases.get("scatter_ms", 0.0))
        self.phase_stats.observe("total", total_ms)
        self.slo.observe(total_ms)
        if self.slow_trace_ms is None or total_ms <= self.slow_trace_ms:
            return
        meta = dict(done.get("meta") or {})
        rid = done.get("request_id")
        with self._stats_lock:
            self.slow_requests_total += 1
            self.last_slow_request_id = rid
            self.info["last_slow_request_id"] = rid
        if self._journal is not None:
            self._journal.write(
                "slow_request",
                request_id=rid,
                model=self.model,
                total_ms=round(total_ms, 3),
                phases={k: round(float(v), 3) for k, v in phases.items()},
                batch_width=done.get("width"),
                batch_rows=done.get("rows"),
                queue_depth=done.get("queue_depth"),
                sessions_active=meta.get("sessions_active"),
                session_evictions=meta.get("session_evictions"),
                dispatch_id=meta.get("dispatch_id"),
                ckpt_step=meta.get("ckpt_step"),
                timed_out=bool(done.get("abandoned")),
            )
            # the forensics survive a crash right after the slow request
            self._journal.sync()

    def drop_session(self, session: str) -> bool:
        """Explicit session release (``/act`` is fire-and-forget; LRU evicts
        the forgetful)."""
        if self.sessions is None:
            return False
        return self.sessions.drop(str(session))

    # -- hot reload --------------------------------------------------------
    def promote(self, params: Any, step: int, path: str, source: str = "watch") -> bool:
        """Swap the served modules for ``params`` (new modules, built off the
        live ones) between dispatches.  Modules whose ``state_dict`` differs
        in keys, shapes, dtypes or device are rejected, never installed."""
        mismatch = self._shape_mismatch(params)
        if mismatch:
            self.reject(path, f"param tree mismatch: {mismatch}")
            return False
        with self._params_lock:
            self._params = params
            self._params_version += 1
            version = self._params_version
            self.ckpt_step = int(step)
            self.ckpt_path = str(path)
            # the handle's reference goes too, so the old modules are freed
            # once the last in-flight dispatch on them drops its own
            self.handle.params = params
        with self._stats_lock:
            self.promotions_total += 1
            self.last_promote_rejected = False
            self.info["ckpt_path"] = str(path)
        if self._journal is not None:
            self._journal.write("ckpt_promote", step=int(step), path=str(path), source=source,
                                params_version=version, model=self.model)
        # a full-height marker between the request spans of the serving trace
        self._tracer.instant("ckpt_promote", step=int(step), model=self.model)
        return True

    def reject(self, path: str, reason: str, anomalies: Optional[List[Dict[str, Any]]] = None) -> None:
        with self._stats_lock:
            self.rejections_total += 1
            self.last_promote_rejected = True
        if self._journal is not None:
            self._journal.write(
                "ckpt_reject",
                step=checkpoint_step(path),
                path=str(path),
                reason=str(reason),
                model=self.model,
                anomalies=[{"kind": e.get("kind"), "subject": e.get("subject"), "step": e.get("step")}
                           for e in (anomalies or [])],
            )

    def _shape_mismatch(self, params: Any) -> Optional[str]:
        with self._params_lock:
            current = self._params
        try:
            old, new = params_state(current), params_state(params)
        except TypeError as err:
            return str(err)
        if set(old) != set(new):
            missing, unknown = sorted(set(old) - set(new)), sorted(set(new) - set(old))
            return f"state_dict keys changed (missing {missing[:4]}, unknown {unknown[:4]})"
        for name, o in old.items():
            n = new[name]
            if tuple(o.shape) != tuple(n.shape):
                return f"{name} shape {tuple(o.shape)} -> {tuple(n.shape)}"
            # dtype matters as much as shape: a bf16-retrained tree would
            # serve other numbers through the same steps
            if o.dtype != n.dtype:
                return f"{name} dtype {o.dtype} -> {n.dtype}"
            if o.device != n.device:
                return f"{name} device {o.device} -> {n.device}"
        return None

    # -- observability -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Metrics-server-shaped snapshot: ``render_prometheus`` exports the
        gauges and counters as the ``sheeprl_serve_*`` /
        ``sheeprl_sessions_*`` families."""
        stats = self.batcher.stats()
        with self._stats_lock:
            promotions_total = self.promotions_total
            rejections_total = self.rejections_total
            slow_requests_total = self.slow_requests_total
            last_promote_rejected = self.last_promote_rejected
            info = dict(self.info)
        gauges: Dict[str, Any] = {
            SERVE_GAUGE_PREFIX + "queue_depth": stats["queue_depth"],
            SERVE_GAUGE_PREFIX + "ckpt_step": self.ckpt_step,
            SERVE_GAUGE_PREFIX + "last_promote_rejected": int(last_promote_rejected),
        }
        for name in ("latency_p50_ms", "latency_p99_ms", "requests_per_sec", "batch_width_mean", "shed_wait_ms"):
            if name in stats:
                gauges[SERVE_GAUGE_PREFIX + name] = stats[name]
        # per-phase p50/p99 ("total" already headlines as latency_p50/p99_ms)
        for phase, (p50, p99) in self.phase_stats.percentiles().items():
            if phase == "total":
                continue
            gauges[SERVE_GAUGE_PREFIX + f"{phase}_ms_p50"] = p50
            gauges[SERVE_GAUGE_PREFIX + f"{phase}_ms_p99"] = p99
        if self.slo.enabled:
            gauges[SERVE_GAUGE_PREFIX + "slo_burn"] = round(self.slo.burn, 4)
        counters: Dict[str, Any] = {
            "serve_requests_total": stats["requests_total"],
            "serve_dispatches_total": stats["dispatches_total"],
            "serve_request_errors_total": stats["errors_total"],
            "serve_shed_total": stats["shed_total"],
            "serve_ckpt_promotions_total": promotions_total,
            "serve_ckpt_rejections_total": rejections_total,
            "serve_slow_requests_total": slow_requests_total,
            "serve_slo_breaches_total": self.slo.breaches_total,
        }
        if self.sessions is not None:
            gauges[SESSIONS_GAUGE_PREFIX + "active"] = self.sessions.active
            gauges[SESSIONS_GAUGE_PREFIX + "capacity"] = self.sessions.capacity
            counters["sessions_created_total"] = self.sessions.created_total
            counters["sessions_evictions_total"] = self.sessions.evictions_total
            counters["sessions_overflow_total"] = self.sessions.overflow_total
        request_log = self.request_log
        if request_log is not None:
            rl = request_log.stats()
            counters["serve_request_log_rows_total"] = rl["rows_total"]
            counters["serve_request_log_shards_total"] = rl["shards_total"]
        return {
            "info": {k: v for k, v in info.items() if v is not None},
            "gauges": gauges,
            "counters": counters,
            "batch_width_hist": stats["width_hist"],
            "latency_hist": self.phase_stats.histogram(),
        }


def render_serving_metrics(snapshot: Mapping[str, Any]) -> str:
    """Prometheus text for ONE service snapshot: the shared renderer plus the
    batch-width histogram as a labeled counter family and the latency
    histogram.  The app's ``/metrics`` renders the whole registry instead
    (:func:`~sheeprl_tpu_torch.serving.registry.render_registry_metrics`)."""
    body = render_prometheus(snapshot)
    hist = snapshot.get("batch_width_hist") or {}
    if hist:
        lines = ["# TYPE sheeprl_serve_batch_width_total counter"]
        for width, count in sorted(hist.items()):
            lines.append(f'sheeprl_serve_batch_width_total{{width="{int(width)}"}} {int(count)}')
        body += "\n".join(lines) + "\n"
    lat_hist = snapshot.get("latency_hist") or {}
    if lat_hist:
        lines = ["# TYPE sheeprl_serve_latency_ms histogram"]
        lines.extend(latency_histogram_lines(lat_hist))
        body += "\n".join(lines) + "\n"
    return body


class CheckpointWatcher(threading.Thread):
    """Poll the checkpoint directory; promote new healthy checkpoints and
    journal the verdict either way.  Also the serving journal's ``metrics``
    heartbeat."""

    def __init__(
        self,
        service: PolicyService,
        watch_dir: str,
        poll_s: float = 2.0,
        health_gate: bool = True,
        allow_unjournaled: bool = True,
        journal: Any = None,
        journal_every_s: float = 10.0,
    ):
        name = f"sheeprl-serve-watcher-{service.model}" if service.model else "sheeprl-serve-watcher"
        super().__init__(name=name, daemon=True)
        self.service = service
        self.watch_dir = str(watch_dir)
        self.poll_s = max(0.05, float(poll_s))
        self.health_gate = bool(health_gate)
        self.allow_unjournaled = bool(allow_unjournaled)
        self._journal = journal
        self.journal_every_s = max(0.0, float(journal_every_s))
        # health rejections can be retried (the gate reads the journal every
        # poll, so an anomaly that later journals anomaly_end unblocks the
        # checkpoint) but journal ckpt_reject once per path; a tree mismatch
        # is permanent for its path
        self._rejected_logged: set = set()
        self._rejected_permanent: set = set()
        # newness of foreign filenames (no ckpt_{step}_{rank} name): newer
        # than whatever was installed last, seeded from the served checkpoint
        try:
            self._promoted_mtime: Optional[float] = os.path.getmtime(service.ckpt_path)
        except OSError:
            self._promoted_mtime = None
        # not named _stop: threading.Thread.join() calls an internal _stop()
        self._stop_event = threading.Event()
        self._last_journal_t = time.monotonic()
        #: what stopped the watcher, when it was not a bad checkpoint file
        self.error: Optional[BaseException] = None

    def stop(self) -> None:
        self._stop_event.set()
        if self.is_alive():
            self.join(timeout=30)

    def run(self) -> None:
        while not self._stop_event.wait(self.poll_s):
            try:
                self.check_once()
            except BAD_CHECKPOINT_ERRORS:
                pass  # a torn or foreign file: the next poll looks again
            except BaseException as err:
                self.error = err  # /healthz reports it; the watcher stops
                raise
            if self._journal is not None and self.journal_every_s:
                now = time.monotonic()
                if now - self._last_journal_t >= self.journal_every_s:
                    self._last_journal_t = now
                    snap = self.service.snapshot()
                    self._journal.write("metrics", step=self.service.batcher.stats()["requests_total"],
                                        metrics=snap["gauges"], model=self.service.model)

    def check_once(self) -> Optional[bool]:
        """One poll: True on a promotion, False on a newly journaled
        rejection, None when there is nothing to do."""
        candidate = latest_checkpoint(self.watch_dir)
        if candidate is None or candidate in self._rejected_permanent:
            return None
        step = checkpoint_step(candidate)
        try:
            mtime = os.path.getmtime(candidate)
        except OSError:
            return None  # vanished between listing and stat
        if step is not None:
            if step <= self.service.ckpt_step:
                return None
        elif self._promoted_mtime is not None and mtime <= self._promoted_mtime:
            return None
        ok, reason, anomalies = checkpoint_health(candidate, health_gate=self.health_gate,
                                                  allow_unjournaled=self.allow_unjournaled)
        if not ok:
            if candidate in self._rejected_logged:
                return None  # still unhealthy: no reject spam, retry next poll
            self._rejected_logged.add(candidate)
            self.service.reject(candidate, reason, anomalies)
            return False
        from sheeprl_tpu_torch.utils.checkpoint import load_state

        agent_state = agent_state_from_checkpoint(load_state(candidate))
        try:
            params = self.service.handle.load_params(agent_state)
        except (KeyError, TypeError, ValueError) as err:
            # the converter refused the tree: another shape, key or dtype
            self._rejected_permanent.add(candidate)
            self.service.reject(candidate, f"param tree mismatch: {err}")
            return False
        promoted = self.service.promote(params, step if step is not None else self.service.ckpt_step, candidate)
        if not promoted:
            self._rejected_permanent.add(candidate)
        else:
            self._promoted_mtime = mtime
            self._rejected_logged.discard(candidate)
        return promoted


def _serve_log_dir(cfg) -> str:
    """Versioned serving run dir (``logs/serve/<run_name>/version_N`` under
    the working directory, as an absolute path): the layout training uses,
    so the journal tools walk both."""
    base = os.path.abspath(os.path.join("logs", "serve", str(cfg.get("run_name") or "serve")))
    os.makedirs(base, exist_ok=True)
    versions = [int(d.split("_")[1]) for d in os.listdir(base) if d.startswith("version_") and d.split("_")[1].isdigit()]
    log_dir = os.path.join(base, f"version_{max(versions) + 1 if versions else 0}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def _archived_model_cfg(app_cfg, ckpt_path: str):
    """One extra model's run config: its own archived ``config.yaml`` (two
    levels up from the checkpoint) when there is one, the app's config
    otherwise; always with the app's ``serving`` block, so every resident
    model shares one batching and reload policy."""
    import yaml

    from sheeprl_tpu_torch.config import own_targets
    from sheeprl_tpu_torch.utils.utils import dotdict

    cfg_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(ckpt_path))), "config.yaml")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as fp:
            cfg = dotdict(own_targets(yaml.safe_load(fp)))
    else:
        cfg = dotdict(dict(app_cfg))
    cfg["serving"] = dict(app_cfg.get("serving") or {})
    return cfg


class ServeApp:
    """Everything the ``serve`` CLI runs: N policies with their services,
    watchers and request logs, and the HTTP server.

    ``ckpt_path`` is the ``default`` model; ``serving.models`` (a mapping of
    ``name: checkpoint_path`` or ``name: {checkpoint_path, watch_dir}``) adds
    more, each with its own archived config, watcher and request log.
    ``start`` returns the bound ``(host, port)``.  ``app.service`` /
    ``app.handle`` / ``app.watcher`` are the default model's."""

    def __init__(self, cfg, ckpt_path: str, device: torch.device | str, watch_dir: Optional[str] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        serving_cfg = dict(cfg.get("serving") or {})
        self.host = str(serving_cfg.get("host", "127.0.0.1"))
        self.port = int(serving_cfg.get("port", 0))
        self.request_timeout_s = float(serving_cfg.get("request_timeout_s", 30.0))
        self._warmup = bool(serving_cfg.get("warmup", True))
        self.log_dir = _serve_log_dir(cfg)
        self.journal = RunJournal(os.path.join(self.log_dir, JOURNAL_NAME))
        # one tracer for the batcher and HTTP threads of every model; its
        # clock_sync anchor (role=server) lets tools/trace_report.py merge the
        # serving timeline with a training run's trace.json
        trace_cfg = dict(serving_cfg.get("trace") or {})
        if trace_cfg.get("enabled", True):
            self.tracer: Any = PhaseTracer(
                os.path.join(self.log_dir, TRACE_SERVE_NAME),
                run_id=os.path.basename(self.log_dir),
                role="server",
                max_events=trace_cfg.get("max_events"),
                rotate_keep=int(trace_cfg.get("rotate_keep", 2)),
            )
        else:
            self.tracer = NullTracer()
        self.registry = ModelRegistry()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        try:
            self._add_model("default", cfg, str(ckpt_path), watch_dir=watch_dir, default=True)
            models = serving_cfg.get("models") or {}
            for name in sorted(models):
                spec = models[name]
                if isinstance(spec, str):
                    extra_ckpt, extra_watch = spec, None
                else:
                    spec = dict(spec or {})
                    extra_ckpt, extra_watch = spec.get("checkpoint_path"), spec.get("watch_dir")
                if not extra_ckpt:
                    raise ValueError(f"serving.models.{name}: checkpoint_path is required")
                self._add_model(str(name), _archived_model_cfg(cfg, str(extra_ckpt)), str(extra_ckpt),
                                watch_dir=extra_watch)
        except BaseException:
            for entry in self.registry.entries():
                entry.service.close()
            self.journal.write("run_end", status="aborted")
            self.journal.close()
            self.tracer.close()
            raise

    def _add_model(self, name: str, cfg, ckpt_path: str, watch_dir: Optional[str] = None,
                   default: bool = False) -> ModelEntry:
        serving_cfg = dict(cfg.get("serving") or {})
        reload_cfg = dict(serving_cfg.get("reload") or {})
        diag_serving = dict((cfg.get("diagnostics") or {}).get("serving") or {})
        handle = load_policy(cfg, ckpt_path, self.device)
        service = PolicyService(handle, serving_cfg, journal=self.journal, model=name, tracer=self.tracer,
                                inject_slow_iter=diag_serving.get("inject_slow_iter"))
        service.info["env"] = (cfg.get("env") or {}).get("id")
        service.info["run_id"] = os.path.basename(self.log_dir)
        request_log = None
        rl_cfg = dict(serving_cfg.get("request_log") or {})
        if rl_cfg.get("enabled"):
            root = rl_cfg.get("dir") or os.path.join(self.log_dir, "requests")
            request_log = RequestLog(os.path.join(str(root), name), handle, model=name,
                                     rotate_rows=int(rl_cfg.get("rotate_rows", 4096)), journal=self.journal,
                                     tracer=self.tracer)
            service.request_log = request_log
        watcher = None
        if reload_cfg.get("enabled", True):
            watcher = CheckpointWatcher(
                service,
                watch_dir or reload_cfg.get("watch_dir") or os.path.dirname(os.path.abspath(ckpt_path)),
                poll_s=float(reload_cfg.get("poll_s", 2.0)),
                health_gate=bool(reload_cfg.get("health_gate", True)),
                allow_unjournaled=bool(reload_cfg.get("allow_unjournaled", True)),
                journal=self.journal,
                journal_every_s=float(serving_cfg.get("journal_every_s", 10.0)),
            )
        return self.registry.add(
            ModelEntry(name=name, service=service, handle=handle, watcher=watcher, request_log=request_log,
                       meta={"ckpt_path": str(ckpt_path)}),
            default=default,
        )

    # the default model's pieces (what single-model callers know)
    @property
    def service(self) -> PolicyService:
        return self.registry.default.service

    @property
    def handle(self) -> PolicyHandle:
        return self.registry.default.handle

    @property
    def watcher(self) -> Optional[CheckpointWatcher]:
        return self.registry.default.watcher

    @property
    def request_log(self) -> Optional[RequestLog]:
        return self.registry.default.request_log

    def start(self) -> Tuple[str, int]:
        registry = self.registry
        timeout_s = self.request_timeout_s
        tracer = self.tracer
        device = str(self.device)
        for entry in registry.entries():
            entry.service.start()
            if self._warmup:
                entry.service.warmup()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: Any) -> None:
                pass

            def _reply(self, status: int, body: bytes, content_type: str = "application/json",
                       headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for header, value in (headers or {}).items():
                    self.send_header(header, value)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:  # noqa: N802 - stdlib API
                # the client's X-Request-Id (an edge proxy's id reaches the
                # slow_request journal and the trace spans), else a new one;
                # echoed on every reply
                request_id = str(self.headers.get("X-Request-Id") or uuid.uuid4().hex[:16])
                rid_header = {"X-Request-Id": request_id}
                if self.path.partition("?")[0] != "/act":
                    self._reply(404, b'{"error": "not found"}', headers=rid_header)
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    entry = registry.get(payload.get("model"))
                    result = entry.service.act(
                        payload.get("obs"),
                        greedy=payload.get("greedy"),
                        timeout_s=min(timeout_s, float(payload.get("timeout_s") or timeout_s)),
                        session=payload.get("session"),
                        reset=bool(payload.get("reset", False)),
                        request_id=request_id,
                    )
                except ServeError as err:
                    headers = dict(rid_header)
                    if err.retry_after is not None:
                        headers["Retry-After"] = str(err.retry_after)
                    self._reply(err.status, json.dumps({"error": str(err)}).encode(), headers=headers)
                    return
                except (ValueError, TypeError, json.JSONDecodeError) as err:
                    self._reply(400, json.dumps({"error": str(err)}).encode(), headers=rid_header)
                    return
                except Exception as err:  # noqa: BLE001 - the handler must answer
                    self._reply(500, json.dumps({"error": repr(err)}).encode(), headers=rid_header)
                    return
                with tracer.span("serve-serialize", request_id=request_id):
                    body = {"action": np.asarray(result["action"]).tolist(),
                            **{k: v for k, v in result.items() if k != "action"}}
                    encoded = json.dumps(body).encode()
                self._reply(200, encoded, headers=rid_header)

            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                path = self.path.partition("?")[0]
                try:
                    if path == "/metrics":
                        self._reply(200, render_registry_metrics(registry).encode(), PROMETHEUS_CONTENT_TYPE)
                    elif path == "/healthz":
                        self._reply(200, json.dumps(_health(registry, device)).encode())
                    else:
                        self._reply(404, b'{"error": "not found"}')
                except Exception as err:  # noqa: BLE001 - snapshot races
                    self._reply(500, json.dumps({"error": repr(err)}).encode())

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, name="sheeprl-serve-http", daemon=True)
        self._thread.start()
        for entry in registry.entries():
            if entry.watcher is not None:
                entry.watcher.start()
        host, port = self._server.server_address[:2]
        default = registry.default
        self.journal.write(
            "serve_start",
            algo=default.handle.algo,
            env=(self.cfg.get("env") or {}).get("id"),
            ckpt=default.service.ckpt_path,
            ckpt_step=default.service.ckpt_step,
            host=str(host),
            port=int(port),
            buckets=list(default.service.buckets),
            watch_dir=default.watcher.watch_dir if default.watcher is not None else None,
            models=registry.names(),
        )
        return str(host), int(port)

    @property
    def address(self) -> Tuple[str, int]:
        if self._server is None:
            raise RuntimeError("ServeApp not started")
        host, port = self._server.server_address[:2]
        return str(host), int(port)

    def close(self, status: str = "completed") -> None:
        for entry in self.registry.entries():
            if entry.watcher is not None:
                entry.watcher.stop()
                entry.watcher = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        failure: Optional[BaseException] = None
        for entry in self.registry.entries():
            try:
                entry.service.close()  # closes the request log too
            except Exception as err:  # noqa: BLE001 - the journal closes first, then it is raised
                failure = failure or err
                status = "aborted"
            entry.request_log = None
        self.journal.write("metrics", step=self.service.batcher.stats()["requests_total"],
                           metrics=self.service.snapshot()["gauges"], model=self.service.model)
        self.journal.write("run_end", status=status)
        self.journal.close()
        self.tracer.close()
        if failure is not None:
            raise failure


def _health(registry: ModelRegistry, device: str) -> Dict[str, Any]:
    """The ``/healthz`` body: the default model at the top level, every
    model under ``models``."""
    default = registry.default
    models: Dict[str, Any] = {}
    status = "ok"
    for entry in registry.entries():
        row: Dict[str, Any] = {
            "algo": entry.handle.algo,
            "ckpt_step": entry.service.ckpt_step,
            "ckpt_path": entry.service.ckpt_path,
            "requests_total": entry.service.batcher.stats()["requests_total"],
            "last_promote_rejected": entry.service.last_promote_rejected,
            "stateful": entry.service.sessions is not None,
        }
        if entry.service.sessions is not None:
            row["sessions"] = {
                "active": entry.service.sessions.active,
                "capacity": entry.service.sessions.capacity,
                "evictions_total": entry.service.sessions.evictions_total,
            }
        if entry.watcher is not None and entry.watcher.error is not None:
            row["watcher_error"] = repr(entry.watcher.error)
            status = "watcher_failed"
        models[entry.name] = row
    return {
        "status": status,
        "algo": default.handle.algo,
        "ckpt_step": default.service.ckpt_step,
        "ckpt_path": default.service.ckpt_path,
        "requests_total": default.service.batcher.stats()["requests_total"],
        "last_promote_rejected": default.service.last_promote_rejected,
        "device": device,
        "models": models,
    }


def serve_checkpoint(cfg, ckpt_path: str, device: torch.device | str, watch_dir: Optional[str] = None) -> None:
    """Blocking CLI loop: start the app, print the address, serve until
    interrupted."""
    app = ServeApp(cfg, ckpt_path, device, watch_dir=watch_dir)
    host, port = app.start()
    extra = f" [models: {', '.join(app.registry.names())}]" if len(app.registry) > 1 else ""
    print(
        f"Serving {app.handle.algo} checkpoint (step {app.service.ckpt_step}) on {app.device} "
        f"at http://{host}:{port}/act  (metrics: /metrics, health: /healthz)" + extra,
        flush=True,
    )
    status = "completed"
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    except BaseException:
        status = "aborted"
        raise
    finally:
        app.close(status)
