"""Run health and observability (counterpart of ``sheeprl_tpu/diagnostics/``).

Seven pillars behind one facade, :class:`Diagnostics`, with the JAX
package's hook names and journal format:

* :mod:`.journal`: the crash-safe JSONL run journal;
* :mod:`.sentinel`: the finiteness guard of the gradient step (``warn`` /
  ``skip_update`` / ``halt``) and the host-side divergence detector;
* :mod:`.tracing`: Chrome-trace spans of the loop's phases;
* :mod:`.telemetry`: the input-signature watchdog, FLOPs from
  ``FlopCounterMode``, MFU against the card's peak and phase accounting,
  and (opt-in) the ``/metrics`` endpoint of :mod:`.metrics_server`;
* :mod:`.memory`: device-memory gauges, the sync guard
  (``torch.cuda.set_sync_debug_mode``) and OOM forensics;
* :mod:`.goodput`: the run-state machine and the stall watchdog;
* :mod:`.health`: gradient, update and parameter statistics of the step and
  the anomaly detectors;

and, from ``sheeprl_tpu_torch/resilience/``, the async manifest-verified
checkpoint writer and graceful preemption.  ``cli.run_algorithm`` builds the
facade and attaches it to the runtime; the loop opens it through
``utils.utils.get_diagnostics`` once its log dir exists, and the logger
proxy (``utils/logger.py``) journals every aggregated metric interval with
the ``Telemetry/*`` gauges merged in.  Every hook is a no-op until opened,
and with ``diagnostics.enabled=False``.
"""

from __future__ import annotations

import hashlib
import os
import time
import warnings
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Mapping, Optional, Sequence

from sheeprl_tpu_torch.diagnostics.goodput import GoodputMonitor
from sheeprl_tpu_torch.diagnostics.health import HealthMonitor, health_spec
from sheeprl_tpu_torch.diagnostics.journal import JOURNAL_NAME, RunJournal
from sheeprl_tpu_torch.diagnostics.memory import MemoryMonitor
from sheeprl_tpu_torch.diagnostics.sentinel import DivergenceDetector, SentinelHalt, SentinelSpec, poison_tree, sentinel_spec
from sheeprl_tpu_torch.diagnostics.telemetry import Telemetry
from sheeprl_tpu_torch.diagnostics.tracing import TRACE_NAME, NullTracer, PhaseTracer

__all__ = ["Diagnostics", "SentinelHalt", "build_diagnostics", "config_hash", "health_spec", "run_id_of"]


def config_hash(cfg: Mapping[str, Any]) -> str:
    """Stable short hash of the composed run config (journaled at
    ``run_start``)."""
    import yaml

    plain = cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg)
    return hashlib.sha256(yaml.safe_dump(plain, sort_keys=True).encode()).hexdigest()[:16]


def run_id_of(log_dir: str) -> str:
    """The run's correlation id: the tail ``<root_dir>/<run_name>/version_N``
    of its log dir."""
    parts = [p for p in os.path.normpath(str(log_dir)).split(os.sep) if p not in ("", ".")]
    return "/".join(parts[-3:]) if parts else str(log_dir)


def _unported(diag_cfg: Mapping[str, Any]) -> None:
    if diag_cfg.get("compilation_cache_dir"):
        raise NotImplementedError(
            "diagnostics.compilation_cache_dir (the JAX compilation and AOT executable caches) has no eager "
            "PyTorch counterpart: see ROADMAP.md Queue 1; pass diagnostics.compilation_cache_dir=null"
        )


class Diagnostics:
    """Facade over the journal, sentinel, tracer, telemetry, memory,
    goodput, health and resilience pillars.

    Construct via :func:`build_diagnostics`; :meth:`open` once the run's
    log dir exists.  Every method is a no-op until opened, and stays one
    with ``diagnostics.enabled=False``, so the loop calls the hooks
    unconditionally.
    """

    def __init__(self, cfg: Optional[Mapping[str, Any]] = None):
        self._cfg = cfg
        diag_cfg = (cfg or {}).get("diagnostics") or {}
        self.enabled = bool(diag_cfg.get("enabled", False))
        # the JAX package turns its compilation cache on at startup, with
        # diagnostics on or off
        _unported(diag_cfg)
        self._journal_cfg = diag_cfg.get("journal") or {}
        self._trace_cfg = diag_cfg.get("trace") or {}
        self.role = str(diag_cfg.get("role") or "main")
        self.sentinel: SentinelSpec = sentinel_spec(cfg or {})
        div_cfg = (diag_cfg.get("sentinel") or {}).get("divergence") or {}
        self._detector: Optional[DivergenceDetector] = None
        if self.enabled and div_cfg.get("enabled", True):
            self._detector = DivergenceDetector(
                window=int(div_cfg.get("window", 20)),
                min_points=int(div_cfg.get("min_points", 5)),
                loss_explosion_ratio=float(div_cfg.get("loss_explosion_ratio", 10.0) or 0.0),
                entropy_key=div_cfg.get("entropy_key"),
                entropy_floor=div_cfg.get("entropy_floor"),
            )
        self.telemetry: Optional[Telemetry] = None
        self.memory: Optional[MemoryMonitor] = None
        self.goodput: Optional[GoodputMonitor] = None
        self.health: Optional[HealthMonitor] = None
        self.resilience = None
        if self.enabled:
            telemetry = Telemetry(cfg or {})
            self.telemetry = telemetry if telemetry.enabled else None
            memory = MemoryMonitor(cfg or {})
            if memory.enabled:
                self.memory = memory
                if self.telemetry is not None:
                    # instrumented dispatches run in the monitor's guarded
                    # scope (sync guard, OOM forensics)
                    self.telemetry._memory = memory
                elif memory.transfer_mode != "off" or memory._inject_transfer_iter is not None \
                        or memory._inject_oom_iter is not None:
                    warnings.warn(
                        f"diagnostics.transfers={memory.transfer_mode!r} (or a memory fault injection) is set but "
                        "diagnostics.telemetry.enabled=False: the sync guard and OOM forensics attach to "
                        "instrumented dispatches and will NOT run.",
                        RuntimeWarning,
                    )
            goodput = GoodputMonitor(cfg or {})
            self.goodput = goodput if goodput.enabled else None
            health = HealthMonitor(cfg or {})
            self.health = health if health.enabled else None
            from sheeprl_tpu_torch.resilience.monitor import ResilienceMonitor

            resilience = ResilienceMonitor(cfg or {})
            self.resilience = resilience if resilience.enabled else None
        self.journal: Optional[RunJournal] = None
        self.tracer = NullTracer()
        self.metrics_server = None
        self.log_dir: Optional[str] = None
        self.run_id: Optional[str] = None
        self.device: Any = None
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def open(self, log_dir: str, device: Any = None) -> "Diagnostics":
        """Open every pillar inside ``log_dir`` (idempotent); ``device`` is
        the run's (the MFU peak and the device-memory source)."""
        if not self.enabled or self.log_dir is not None:
            return self
        self.log_dir = str(log_dir)
        self.run_id = run_id_of(self.log_dir)
        self.device = device
        if self._trace_cfg.get("enabled", False):
            self.tracer = PhaseTracer(
                self._trace_cfg.get("path") or os.path.join(self.log_dir, TRACE_NAME),
                pid=0,
                max_events=self._trace_cfg.get("max_events"),
                rotate_keep=int(self._trace_cfg.get("rotate_keep", 2)),
                run_id=self.run_id,
                role=self.role,
            )
        if self._journal_cfg.get("enabled", True):
            self.journal = RunJournal(
                os.path.join(self.log_dir, JOURNAL_NAME),
                fsync_every=int(self._journal_cfg.get("fsync_every", 1)),
            )
        cfg = self._cfg or {}
        if self.journal is not None:
            self.journal.write(
                "run_start",
                config_hash=config_hash(cfg),
                algo=(cfg.get("algo") or {}).get("name"),
                env=(cfg.get("env") or {}).get("id"),
                seed=cfg.get("seed"),
                exp_name=cfg.get("exp_name"),
                run_name=cfg.get("run_name"),
                log_dir=self.log_dir,
                run_id=self.run_id,
                sentinel_policy=self.sentinel.policy if self.sentinel.enabled else None,
                package="sheeprl_tpu_torch",
                device=str(device) if device is not None else None,
            )
        if self.resilience is not None:
            self.resilience.open(self._journal_event)
        if self.memory is not None:
            self.memory.open(self._journal_event, self._journal_sync, device=device)
        if self.health is not None:
            self.health.open(self._journal_event, self._journal_sync)
        if self.goodput is not None:
            self.goodput.open(self._goodput_event, self._journal_sync, telemetry=self.telemetry,
                              log_dir=self.log_dir)
            if self.telemetry is None:
                warnings.warn(
                    "diagnostics.goodput.enabled=True but diagnostics.telemetry.enabled=False: "
                    "Telemetry/goodput and Telemetry/time_to_first_step will be omitted "
                    "(the run-state machine and stall watchdog still run on span/interval hooks).",
                    RuntimeWarning,
                )
        if self.telemetry is not None:
            self.telemetry.open(
                self._journal_event,
                {
                    "run_id": self.run_id,
                    "algo": (cfg.get("algo") or {}).get("name"),
                    "env": (cfg.get("env") or {}).get("id"),
                    "role": self.role,
                },
                device=device,
            )
            if self.goodput is not None:
                self.telemetry._goodput = self.goodput
            if self.telemetry.http_enabled:
                self._start_metrics_server()
        return self

    def _start_metrics_server(self) -> None:
        from sheeprl_tpu_torch.diagnostics.metrics_server import MetricsServer

        profile_fn = None
        if self.goodput is not None and self.goodput.profile_enabled:
            profile_fn = self.goodput.capture_profile
        try:
            self.metrics_server = MetricsServer(self._server_snapshot, host=self.telemetry.http_host,
                                                port=self.telemetry.http_port, profile_fn=profile_fn)
            host, port = self.metrics_server.start()
        except OSError as err:
            # a taken port must not take the run down with it
            self.metrics_server = None
            warnings.warn(f"diagnostics metrics endpoint failed to bind: {err}", RuntimeWarning)
            self._journal_event("metrics_server", status="bind_failed", error=str(err))
            return
        self._journal_event("metrics_server", status="serving", host=host, port=port)
        print(f"Telemetry endpoint: http://{host}:{port}/metrics (and /healthz)", flush=True)

    @property
    def metrics_url(self) -> Optional[str]:
        """``http://host:port`` of the live endpoint, or None."""
        if self.metrics_server is None or self.metrics_server._server is None:
            return None
        host, port = self.metrics_server.address
        return f"http://{host}:{port}"

    def _server_snapshot(self) -> Dict[str, Any]:
        snap = self.telemetry.snapshot() if self.telemetry is not None else {}
        for pillar in (self.memory, self.goodput, self.health, self.resilience):
            if pillar is None:
                continue
            part = pillar.snapshot()
            snap.setdefault("gauges", {}).update(part["gauges"])
            snap.setdefault("counters", {}).update(part["counters"])
            info = snap.setdefault("info", {})
            for k, v in part["info"].items():
                if v is not None:
                    info.setdefault(k, v)
        if self.journal is not None and self.journal.last_write_t is not None:
            snap["journal_lag_seconds"] = round(time.time() - self.journal.last_write_t, 3)
        return snap

    def _journal_event(self, event: str, **fields: Any) -> None:
        if self.journal is not None:
            self.journal.write(event, **fields)

    def _goodput_event(self, event: str, **fields: Any) -> None:
        """Goodput's events go to the journal and, as instants, the trace."""
        self._journal_event(event, **fields)
        if event == "state_change":
            self.tracer.instant(f"state:{fields.get('state')}", prev=fields.get("prev"))
        elif event in ("stall", "stall_end"):
            self.tracer.instant(event)

    def _journal_sync(self) -> None:
        if self.journal is not None:
            self.journal.sync()

    def close(self, status: str = "completed") -> None:
        """Close every pillar; ``run_end`` with ``status`` is the journal's
        last line.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        if self.resilience is not None:
            # first: a pending (possibly emergency) snapshot lands, and
            # journals its ckpt_end, before run_end
            self.resilience.close()
        if self.goodput is not None:
            self.goodput.close()
        if self.journal is not None and (self.telemetry is not None or self.goodput is not None):
            summary = self.telemetry.summary() if self.telemetry is not None else {}
            for pillar in (self.goodput, self.health, self.resilience):
                if pillar is not None:
                    summary.update(pillar.summary())
            self.journal.write("telemetry_summary", **summary)
        if self.telemetry is not None:
            self.telemetry.close()
        if self.memory is not None and self.journal is not None:
            self.journal.write("memory_summary", **self.memory.summary())
        if self.journal is not None:
            self.journal.write("run_end", status=status)
            self.journal.close()
        self.tracer.close()

    # -- tracing + phase accounting ----------------------------------------
    def span(self, name: str, **args: Any):
        """Phase span: telemetry's phase accounting, the run-state machine
        and, with tracing on, the Chrome trace."""
        tracing = not isinstance(self.tracer, NullTracer)
        if self.telemetry is None and not tracing and self.goodput is None:
            return nullcontext()
        return self._span(name, args, tracing)

    @contextmanager
    def _span(self, name: str, args: Dict[str, Any], tracing: bool):
        if self.goodput is not None:
            self.goodput.note_span(name)
        token = self.telemetry.span_enter(name) if self.telemetry is not None else None
        try:
            if tracing:
                with self.tracer.span(name, **args):
                    yield
            else:
                yield
        finally:
            if token is not None:
                self.telemetry.span_exit(token)

    # -- telemetry hooks ---------------------------------------------------
    def instrument(self, name: str, fn, kind: str = "train", cost_note: Optional[str] = None):
        """Wrap a step for the signature watchdog and FLOP accounting
        (``kind="train"``); identity when telemetry is off."""
        if self.telemetry is None:
            return fn
        return self.telemetry.instrument(name, fn, kind=kind, cost_note=cost_note)

    def build_kernels(self, names: Sequence[str]) -> None:
        """Build and load the hand-written kernels the run launches, as the
        run state ``compiling``: ``nvcc`` at first use is the port's
        compile, covered by the stall watchdog's ``compile_grace`` and
        counted in ``time_to_first_step``."""
        from sheeprl_tpu_torch.ops import cuda_build

        for name in names:
            if self.goodput is not None:
                self.goodput.note_compile_start(name)
            t0 = time.perf_counter()
            cuda_build.load(name)
            if self.telemetry is not None:
                self.telemetry.note_kernel_build(time.perf_counter() - t0)

    def note_env_steps(self, n: int) -> None:
        if self.telemetry is not None:
            self.telemetry.note_env_steps(n)

    def note_fetch(self, n: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.note_fetch(n)

    def note_dataset_read(self, n: int) -> None:
        """Count ``n`` transitions streamed from the offline dataset loader
        toward ``Telemetry/dataset_read_sps``."""
        if self.telemetry is not None:
            self.telemetry.note_dataset_rows(n)

    def note_dataset_epoch(self, epoch: float) -> None:
        """The offline loader's pass over its dataset
        (``Telemetry/dataset_epoch``)."""
        if self.telemetry is not None:
            self.telemetry.note_dataset_epoch(epoch)

    def augment_metrics(self, step: Optional[int], metrics: Mapping[str, Any]) -> Mapping[str, Any]:
        """Merge the interval's ``Telemetry/*`` gauges into an aggregated
        metrics dict (the logger proxy calls this before the backend logs)."""
        extra: Dict[str, Any] = {}
        if self.telemetry is not None:
            extra.update(self.telemetry.interval_metrics(step))
        if self.memory is not None and self.log_dir is not None:
            extra.update(self.memory.interval_metrics())
        if self.goodput is not None:
            extra.update(self.goodput.interval_metrics())
        if self.health is not None:
            extra.update(self.health.interval_metrics())
        if not extra:
            return metrics
        merged = dict(metrics)
        merged.update(extra)
        return merged

    # -- learning-health hooks ---------------------------------------------
    def on_health(self, step: Optional[int], stats: Mapping[str, Any]) -> None:
        """Digest one log interval's mean ``health_stats``: the
        ``Telemetry/health/*`` gauges and the stats-fed detectors."""
        if self.health is not None and stats:
            self.health.on_stats(step, stats)

    # -- memory hooks ------------------------------------------------------
    def register_footprint(self, name: str, tree_or_bytes: Any) -> None:
        if self.memory is not None:
            self.memory.register_footprint(name, tree_or_bytes)

    def track_buffer(self, name: str, buffer: Any) -> None:
        if self.memory is not None:
            self.memory.track_buffer(name, buffer)

    # -- journal hooks -----------------------------------------------------
    def log_metrics(self, step: Optional[int], metrics: Mapping[str, Any]) -> None:
        """Journal one aggregated-metrics interval and run the divergence and
        health detectors on it (the logger proxy calls this after the
        backend logged)."""
        if not metrics:
            return
        if self.journal is not None:
            self.journal.write("metrics", step=step, metrics=dict(metrics))
        if self._detector is not None:
            for event in self._detector.observe(step, metrics):
                self._journal_divergence(event)
        if self.health is not None:
            self.health.observe_metrics(step, metrics)

    def on_checkpoint(self, step: Optional[int], path: str) -> None:
        if self.journal is not None:
            self.journal.write("checkpoint", step=step, path=str(path))
        self.tracer.instant("checkpoint", step=step)

    # -- resilience hooks ----------------------------------------------------
    def save_checkpoint(self, path: str, state: Mapping[str, Any]) -> bool:
        """Route one save through the resilience layer (async writer or
        blocking with journaling; a manifest either way).  False when the
        layer is off or unopened: ``Runtime.save`` then saves itself."""
        if self.resilience is None or not self.resilience._opened:
            return False
        self.resilience.save(path, state)
        return True

    def preempt_due(self, iter_num: int) -> bool:
        """True once a preemption (SIGTERM/SIGINT, or
        ``diagnostics.resilience.inject_preempt_iter``) is pending: the loop
        forces its checkpoint branch and calls :meth:`on_preempted`."""
        return self.resilience is not None and self.resilience.preempt_due(iter_num)

    def on_preempted(self, step: Optional[int], iter_num: int, ckpt_path: str) -> None:
        """Finish a graceful preemption: drain the async writer, journal the
        fsync'd ``preempted`` record, close the run as ``preempted`` and
        raise :class:`~sheeprl_tpu_torch.resilience.preemption.PreemptedExit`
        (exit code 75)."""
        from sheeprl_tpu_torch.resilience.preemption import PreemptedExit

        reason = "preempt"
        durable = True
        if self.resilience is not None:
            reason = self.resilience.preempt_reason
            durable = self.resilience.flush()
        self._journal_event("preempted", step=step, iter_num=int(iter_num), path=str(ckpt_path), reason=reason,
                            snapshot_durable=durable)
        self._journal_sync()
        self.close("preempted")
        raise PreemptedExit(f"preempted ({reason}) at iteration {iter_num}: emergency checkpoint {ckpt_path}")

    def _journal_divergence(self, event: Dict[str, Any]) -> None:
        if self.telemetry is not None:
            self.telemetry.count_sentinel_event()
        if self.journal is not None:
            kind = event.pop("kind", "unknown")
            step = event.pop("step", None)
            self.journal.write("divergence", kind=kind, step=step, **event)
            self.tracer.instant(f"divergence:{kind}", step=step)

    # -- sentinel host side ------------------------------------------------
    def on_update(self, step: Optional[int], stats: Mapping[str, Any], nonfinite: float = 0.0) -> None:
        """Digest the non-finite gradient steps of one fetch: journal a
        ``divergence`` and apply the policy (``warn`` warns, ``skip_update``
        already discarded them on the device, ``halt`` raises
        :class:`SentinelHalt`)."""
        if not (self.enabled and self.sentinel.enabled):
            return
        nonfinite = float(nonfinite)
        if nonfinite <= 0:
            return
        self._journal_divergence({"kind": "nonfinite_update", "step": step, "nonfinite_steps": nonfinite,
                                  "policy": self.sentinel.policy, **dict(stats)})
        if self.sentinel.policy == "halt":
            self.close("halted")
            raise SentinelHalt(
                f"non-finite training update at step {step} (nonfinite optimizer steps this interval: "
                f"{nonfinite:g}); diagnostics.sentinel.policy=halt"
            )
        if self.sentinel.policy == "warn":
            warnings.warn(
                f"Sentinel: non-finite training update at step {step} ({nonfinite:g} optimizer steps); params "
                "may be corrupted (diagnostics.sentinel.policy=warn)",
                RuntimeWarning,
            )

    def observe_rows(self, step: Optional[int], names, rows) -> None:
        """The sentinel's digest of the DreamerV3 metric rows fetched at the
        log boundary: counts the rows with a non-finite entry."""
        if not (self.enabled and self.sentinel.enabled) or len(rows) == 0:
            return
        import numpy as np

        arr = np.asarray(rows, dtype=np.float64)
        bad = ~np.isfinite(arr).all(axis=tuple(range(1, arr.ndim)))
        n_bad = int(bad.sum())
        if n_bad:
            stats = {str(n): float(v) for n, v in zip(names, arr[bad][0])}
            self.on_update(step, stats, nonfinite=n_bad)

    # -- fault injection ---------------------------------------------------
    def maybe_inject_nan(self, iter_num: int, tree):
        """Poison a train batch at ``diagnostics.sentinel.inject_nan_iter``
        (the sentinel drill)."""
        inject = self.sentinel.inject_nan_iter
        if inject is None or int(iter_num) != inject:
            return tree
        if self.journal is not None:
            self.journal.write("fault_injection", iter_num=int(iter_num))
        return poison_tree(tree)


def build_diagnostics(cfg: Optional[Mapping[str, Any]]) -> Diagnostics:
    """The facade of a composed run config (a config without a
    ``diagnostics`` section gets a disabled one)."""
    return Diagnostics(cfg)
