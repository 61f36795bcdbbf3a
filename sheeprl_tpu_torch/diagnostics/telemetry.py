"""Performance telemetry (counterpart of ``sheeprl_tpu/diagnostics/telemetry.py``):
the input-signature watchdog and MFU/goodput accounting.

* **Signature watchdog**: the training loop wraps its gradient step with
  :meth:`Telemetry.instrument`.  Every dispatch computes the arguments'
  signature (tree structure, each tensor's shape and dtype, each other
  leaf's type); eager PyTorch compiles nothing when it changes, but a
  captured CUDA graph of the step would have to be captured again, so a
  never-seen signature after the first is journaled with the JAX event
  kinds, a ``recompile`` carrying the leaf diff (and ``recompile_storm``
  when too many land in a window).  Python numbers count by type, not value:
  ``tau`` changes every few steps and would become a device scalar in a
  graph.
* **MFU**: at the first dispatch of each new signature the step runs once
  under ``torch.utils.flop_counter.FlopCounterMode`` (that real step, not an
  extra one: an extra step would move the weights and the random stream),
  and its FLOPs are journaled as ``telemetry_cost``; a later run in the
  same process with the same widths (:func:`step_cost_key`) and signature
  journals the count kept from the first, with ``count_s`` 0.  ``FlopCounterMode``
  counts matrix products and convolutions (forward and backward) only,
  where XLA's ``cost_analysis`` counts every operation; the LayerNorm-GRU
  kernel, a ``ctypes`` launch it cannot see, counts through the FLOP formula
  ``ops/ln_gru.py`` registers for its custom op, so the card and the CPU
  count the same.  Per log interval the dispatched train FLOPs over
  wall-clock give ``Telemetry/tflops_per_sec`` and, against the card's peak
  (:func:`resolve_peak_flops`) or ``telemetry.mfu.peak_tflops_per_device``,
  ``Telemetry/mfu``; the policy-step counter gives ``Telemetry/sps``.
* **Phase attribution**: the facade's spans (rollout / env_step_async /
  env_wait / buffer-sample / train / checkpoint) feed a nesting-aware
  self-time accumulator, reported per interval as
  ``Telemetry/phase_pct/{train,env,fetch,other,idle}``.

Eager PyTorch has no AOT compile path to fall back from, so a failed
dispatch is never caught here: it raises into the loop (after the memory
monitor journals an OOM or a blocked sync).  The JAX package's persistent
executable cache (``diagnostics.compilation_cache_dir``) has no eager
counterpart; a non-null value raises.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

TELEMETRY_PREFIX = "Telemetry/"

#: what ``telemetry_cost`` says of the FLOPs it journals
COST_NOTE = (
    "FlopCounterMode counts matrix products and convolutions only (forward and backward; the LayerNorm-GRU "
    "kernel through its registered formula 2*B*K*3H), where XLA's cost_analysis counts every operation"
)

# Dense peak FLOP/s of one card by the name torch.cuda.get_device_name()
# reports (NVIDIA's data sheets, at the full power limit).  fp32 is the
# CUDA-core rate: the port keeps TF32 off (parallel/runtime.py).  Unknown
# names (and the CPU) resolve to None: MFU is then reported only when
# ``telemetry.mfu.peak_tflops_per_device`` is set, since an assumed
# denominator would make the gauge silently wrong.
_PEAKS: Dict[str, Dict[str, float]] = {
    "h100 sxm": {"bf16": 989.4e12, "f32": 66.9e12},
}


def resolve_peak_flops(device_name: str, precision: str) -> Optional[float]:
    """Peak FLOP/s of one card for a device name and ``fabric.precision``,
    or None when the name is not in the table."""
    name = (device_name or "").lower()
    table = None
    if "h100" in name and ("hbm3" in name or "sxm" in name):
        table = _PEAKS["h100 sxm"]
    if table is None:
        return None
    return table["bf16"] if ("bf16" in precision or "16" in precision) else table["f32"]


# ---------------------------------------------------------------------------
# signatures


def _flatten(tree: Any, path: str, out: List[Tuple[str, Any]], struct: List[str]) -> None:
    if isinstance(tree, Mapping):
        struct.append("{" + ",".join(str(k) for k in tree) + "}")
        for k, v in tree.items():
            _flatten(v, f"{path}[{k!r}]", out, struct)
    elif isinstance(tree, (list, tuple)):
        struct.append(f"{type(tree).__name__}{len(tree)}")
        for i, v in enumerate(tree):
            _flatten(v, f"{path}[{i}]", out, struct)
    else:
        out.append((path, tree))


def _leaf_sig(leaf: Any) -> Tuple:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype), str(getattr(leaf, "device", "")))
    return ("pyleaf", type(leaf).__name__, "")


def tree_signature(args: Tuple[Any, ...], kwargs: Mapping[str, Any]) -> Tuple[str, Tuple]:
    """Hashable dispatch signature of a call: the tree structure and, per
    leaf, a tensor's (shape, dtype, device) or another leaf's type."""
    leaves: List[Tuple[str, Any]] = []
    struct: List[str] = []
    _flatten((args, dict(kwargs)), "", leaves, struct)
    return ("|".join(struct), tuple(_leaf_sig(leaf) for _, leaf in leaves))


def _leaf_paths(args: Tuple[Any, ...], kwargs: Mapping[str, Any]) -> List[str]:
    leaves: List[Tuple[str, Any]] = []
    _flatten((args, dict(kwargs)), "", leaves, [])
    return [path for path, _ in leaves]


def signature_diff(
    old: Optional[Tuple[str, Tuple]], new: Tuple[str, Tuple], paths: List[str]
) -> List[str]:
    """Human-readable leaf-level diff between two signatures (what the
    ``recompile`` journal event carries)."""
    if old is None:
        return ["first dispatch"]
    changes: List[str] = []
    if old[0] != new[0]:
        changes.append("tree structure changed")
    old_leaves, new_leaves = old[1], new[1]
    n = max(len(old_leaves), len(new_leaves))
    for i in range(n):
        o = old_leaves[i] if i < len(old_leaves) else None
        nw = new_leaves[i] if i < len(new_leaves) else None
        if o == nw:
            continue
        label = paths[i] if i < len(paths) else f"leaf[{i}]"
        changes.append(f"{label}: {_fmt_leaf(o)} -> {_fmt_leaf(nw)}")
        if len(changes) >= 16:  # a storm of changed leaves needs no full list
            changes.append(f"... ({n - i - 1} more leaves)")
            break
    return changes or ["signature changed"]


def _fmt_leaf(leaf_sig: Optional[Tuple]) -> str:
    if leaf_sig is None:
        return "<absent>"
    if leaf_sig[0] == "pyleaf":
        return leaf_sig[1]
    shape, dtype, device = leaf_sig
    return f"{dtype}{list(shape)}@{device}"


def count_flops(call: Callable[[], Any]) -> Tuple[Any, float]:
    """Run ``call`` once under ``FlopCounterMode``; returns its result and
    the FLOPs counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from sheeprl_tpu_torch.ops import ln_gru  # noqa: F401  (registers the kernel's FLOP formula)

    counter = FlopCounterMode(display=False)
    with counter:
        out = call()
    return out, float(counter.get_total_flops())


#: the FLOPs of each step this process counted, by :func:`step_cost_key`
#: and dispatch signature: a run of the same widths (its resume, its eval,
#: the step timers) reuses the count instead of running ``FlopCounterMode``
#: again
_FLOPS_COUNTED: Dict[Tuple[Any, ...], float] = {}
_FLOPS_LOCK = threading.Lock()
#: the ``algo`` keys that set how long a run trains, never what one step
#: computes
_RUN_LENGTH_KEYS = ("total_steps", "learning_starts", "replay_ratio", "run_test", "per_rank_pretrain_steps")


def step_cost_key(cfg: Mapping[str, Any]) -> str:
    """What decides the FLOPs of a run's step besides its dispatch signature:
    the ``algo`` section but for its run-length keys, the action
    distribution, the env, ``fabric.precision`` and the health stats."""
    import json

    cfg = cfg or {}
    algo = {k: v for k, v in (cfg.get("algo") or {}).items() if k not in _RUN_LENGTH_KEYS}
    return json.dumps([algo, cfg.get("distribution"), (cfg.get("env") or {}).get("id"),
                       (cfg.get("fabric") or {}).get("precision"),
                       (cfg.get("diagnostics") or {}).get("health")], sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# instrumented dispatch


class _Instrumented:
    """Wrapper around one step callable: signature watch and FLOP capture.

    ``kind="train"`` counts the FLOPs of the first dispatch of each new
    signature under ``FlopCounterMode``; FLOPs are kept per signature, and
    bouncing back to a signature seen before is no new dispatch signature.
    """

    def __init__(
        self,
        telemetry: "Telemetry",
        name: str,
        fn: Callable,
        kind: str,
        cost_note: Optional[str] = None,
    ):
        self._telemetry = telemetry
        self._fn = fn
        self.name = name
        self.kind = kind
        self.donate_argnums: Tuple[int, ...] = ()
        self.cost_note = cost_note
        self._count = kind == "train" and telemetry.cost_analysis_enabled
        self._signature: Optional[Tuple[str, Tuple]] = None
        self._seen: set = set()
        self._flops_by_sig: Dict[Tuple[str, Tuple], float] = {}

    def __getattr__(self, name: str) -> Any:
        # the step's own attributes (e.g. the DreamerV3 step's health_names)
        if name == "_fn":
            raise AttributeError(name)
        return getattr(self._fn, name)

    def __call__(self, *args: Any, **kwargs: Any):
        tele = self._telemetry
        sig = tree_signature(args, kwargs)
        new_sig = sig not in self._seen
        if new_sig:
            if self._seen:
                tele._watchdog_observe(self, sig, args, kwargs)
            self._seen.add(sig)
        self._signature = sig
        if new_sig and self._count:
            memo_key = (self.name, tele.cost_key, sig)
            with _FLOPS_LOCK:
                flops = _FLOPS_COUNTED.get(memo_key)
            if flops is None:
                t0 = time.perf_counter()
                out, flops = count_flops(lambda: self._invoke(args, kwargs))
                count_s = time.perf_counter() - t0
                with _FLOPS_LOCK:
                    _FLOPS_COUNTED[memo_key] = flops
            else:
                out, count_s = self._invoke(args, kwargs), 0.0
            if flops:
                self._flops_by_sig[sig] = flops
                tele._journal(
                    "telemetry_cost",
                    fn=self.name,
                    flops_per_call=flops,
                    count_s=round(count_s, 3),
                    note=COST_NOTE + (f"; {self.cost_note}" if self.cost_note else ""),
                )
        else:
            out = self._invoke(args, kwargs)
        tele._record_call(self)
        return out

    def _invoke(self, args: Tuple[Any, ...], kwargs: Mapping[str, Any]):
        """The dispatch, through the memory monitor's guarded scope (the
        sync guard, fault injection, OOM forensics) when one is attached."""
        mem = self._telemetry._memory
        if mem is None:
            return self._fn(*args, **kwargs)
        return mem.guarded_call(self, lambda: self._fn(*args, **kwargs), args, kwargs)

    @property
    def flops_per_call(self) -> Optional[float]:
        """FLOPs of the signature dispatched last (None until counted)."""
        if self._signature is not None and self._signature in self._flops_by_sig:
            return self._flops_by_sig[self._signature]
        return next(iter(self._flops_by_sig.values()), None)


# ---------------------------------------------------------------------------
# telemetry core


class Telemetry:
    """Per-run performance accounting: watchdog state, FLOP/phase/step
    counters and the interval math behind the ``Telemetry/*`` gauges.

    Thread-safe (the metrics server snapshots from its own thread).
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, cfg: Optional[Mapping[str, Any]], clock: Callable[[], float] = time.perf_counter):
        cfg = cfg or {}
        diag_cfg = (cfg.get("diagnostics") or {}) if cfg else {}
        tele_cfg = diag_cfg.get("telemetry") or {}
        self.enabled = bool(tele_cfg.get("enabled", True))
        wd_cfg = tele_cfg.get("watchdog") or {}
        self.watchdog_enabled = bool(wd_cfg.get("enabled", True))
        # clamped: threshold 0 would turn every new signature into a storm
        self.storm_threshold = max(1, int(wd_cfg.get("storm_threshold", 5)))
        self.storm_window_s = float(wd_cfg.get("storm_window_s", 60.0))
        inject = wd_cfg.get("inject_shape_change_iter")
        self.inject_shape_change_iter = None if inject is None else int(inject)
        mfu_cfg = tele_cfg.get("mfu") or {}
        self.mfu_enabled = bool(mfu_cfg.get("enabled", True))
        self.cost_analysis_enabled = self.mfu_enabled and bool(mfu_cfg.get("cost_analysis", True))
        self._peak_override = mfu_cfg.get("peak_tflops_per_device")
        http_cfg = tele_cfg.get("http") or {}
        self.http_enabled = bool(http_cfg.get("enabled", False))
        self.http_host = str(http_cfg.get("host", "127.0.0.1"))
        self.http_port = int(http_cfg.get("port", 0))
        self._precision = str((cfg.get("fabric") or {}).get("precision", "32-true")) if cfg else "32-true"
        self.cost_key = step_cost_key(cfg)
        self._clock = clock
        # the facade attaches the MemoryMonitor (sync guard, OOM forensics)
        # and the rank-0 GoodputMonitor (run-state machine, stall watchdog)
        self._memory = None
        self._goodput = None
        self._lock = threading.Lock()
        self._journal_fn: Optional[Callable[..., None]] = None
        self._span_stack = threading.local()

        # phase self-times (seconds): cumulative + current interval
        self._phase_total: Dict[str, float] = {}
        self._phase_interval: Dict[str, float] = {}
        # instrumented-call accounting
        self._instrumented: Dict[str, _Instrumented] = {}
        self._calls_total: Dict[str, int] = {}
        self._calls_interval: Dict[str, int] = {}
        self._train_flops_interval = 0.0
        self._train_flops_total = 0.0
        # env throughput and how many env steps each blocking action fetch
        # amortizes
        self._env_steps_interval = 0
        self._env_steps_total = 0
        self._rollout_calls_interval = 0
        # the offline loop's dataset feed: rows streamed and the loader's pass
        self._dataset_rows_interval = 0
        self._dataset_rows_total = 0
        self._dataset_epoch: Optional[float] = None
        # watchdog
        self._recompiles_total = 0
        self._recompile_times: deque = deque()
        self._storms_total = 0
        # kernel builds (nvcc at first use): the port's compiles
        self._backend_compiles = 0
        self._backend_compile_s = 0.0
        self._sentinel_events = 0
        # interval bookkeeping
        self._tick_t: Optional[float] = None
        self._tick_step: Optional[float] = None
        self._peak_flops_total: Optional[float] = None
        self._device_count = 1
        self._latest: Dict[str, float] = {}
        self._info: Dict[str, Any] = {}

    # -- lifecycle ---------------------------------------------------------
    def open(
        self,
        journal_fn: Optional[Callable[..., None]] = None,
        info: Optional[Mapping[str, Any]] = None,
        device: Any = None,
    ) -> None:
        self._journal_fn = journal_fn
        self._info = dict(info or {})
        self._tick_t = self._clock()
        self._resolve_peak(device)

    def close(self) -> None:
        pass

    def _resolve_peak(self, device: Any) -> None:
        """The MFU denominator for the run's device: the card's name on a
        CUDA device, ``cpu`` (no peak) otherwise."""
        kind = "cpu"
        if device is not None and str(device).startswith("cuda"):
            import torch

            kind = torch.cuda.get_device_name(torch.device(device))
        if self._peak_override is not None:
            per_device = float(self._peak_override) * 1e12
        else:
            per_device = resolve_peak_flops(kind, self._precision)
        if per_device:
            self._peak_flops_total = per_device * self._device_count
        self._info.setdefault("device_kind", kind)

    def _journal(self, event: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(event, **fields)

    # -- instrumentation ---------------------------------------------------
    def instrument(self, name: str, fn: Callable, kind: str = "train", cost_note: Optional[str] = None) -> Callable:
        if not self.enabled:
            return fn
        wrapped = _Instrumented(self, name, fn, kind, cost_note=cost_note)
        self._instrumented[name] = wrapped
        return wrapped

    def _record_call(self, inst: _Instrumented) -> None:
        with self._lock:
            self._calls_total[inst.name] = self._calls_total.get(inst.name, 0) + 1
            self._calls_interval[inst.name] = self._calls_interval.get(inst.name, 0) + 1
            if inst.kind == "train" and inst.flops_per_call:
                self._train_flops_interval += inst.flops_per_call
                self._train_flops_total += inst.flops_per_call
            if inst.kind == "rollout":
                self._rollout_calls_interval += 1
        if self._goodput is not None:
            # outside the lock: the stall fault injection sleeps in this
            # notification while the watchdog thread reads counters here
            self._goodput.note_dispatch(inst.name, inst.kind)

    def note_env_steps(self, n: int) -> None:
        """Count ``n`` environment steps (once per vector step with
        ``num_envs``): ``Telemetry/env_steps_per_sec`` and the
        fetch-amortization gauge."""
        with self._lock:
            self._env_steps_interval += int(n)
            self._env_steps_total += int(n)

    def note_dataset_rows(self, n: int) -> None:
        """Count ``n`` transitions streamed from an offline dataset loader:
        ``Telemetry/dataset_read_sps``."""
        with self._lock:
            self._dataset_rows_interval += int(n)
            self._dataset_rows_total += int(n)

    def note_dataset_epoch(self, epoch: float) -> None:
        """The offline loader's current pass over its dataset: the
        ``Telemetry/dataset_epoch`` gauge."""
        with self._lock:
            self._dataset_epoch = float(epoch)

    def note_fetch(self, n: int = 1) -> None:
        """Count a blocking obs->action fetch (the DreamerV3 player's)."""
        with self._lock:
            self._rollout_calls_interval += int(n)

    def note_kernel_build(self, seconds: float) -> None:
        """Count one kernel build (``nvcc`` at first use), the port's
        counterpart of a backend compile."""
        with self._lock:
            self._backend_compiles += 1
            self._backend_compile_s += float(seconds)

    def _watchdog_observe(self, inst: _Instrumented, sig, args, kwargs) -> None:
        """One new dispatch signature after the first: a CUDA graph of the
        step would be captured again (journaled as ``recompile``)."""
        if not self.watchdog_enabled:
            return
        diff = signature_diff(inst._signature, sig, _leaf_paths(args, kwargs))
        now = self._clock()
        with self._lock:
            self._recompiles_total += 1
            total = self._recompiles_total
            self._recompile_times.append(now)
            while self._recompile_times and now - self._recompile_times[0] > self.storm_window_s:
                self._recompile_times.popleft()
            storm = len(self._recompile_times) >= self.storm_threshold
            if storm:
                self._storms_total += 1
                self._recompile_times.clear()  # cooldown: re-arm the window
        self._journal(
            "recompile", fn=inst.name, count=total, diff=diff,
            meaning="new input signature of the eager step: a CUDA graph of it would be captured again",
        )
        if storm:
            self._journal(
                "recompile_storm",
                recompiles_in_window=self.storm_threshold,
                window_s=self.storm_window_s,
                total=total,
            )
            warnings.warn(
                f"Signature storm: >= {self.storm_threshold} new input signatures of the train step within "
                f"{self.storm_window_s:g}s (total {total}); check the `recompile` journal events for the leaf diff.",
                RuntimeWarning,
            )

    def count_sentinel_event(self, n: int = 1) -> None:
        with self._lock:
            self._sentinel_events += int(n)

    def train_seconds(self) -> float:
        """Cumulative self-time of the ``train`` spans: goodput's numerator."""
        with self._lock:
            return self._phase_total.get("train", 0.0)

    # -- phase spans -------------------------------------------------------
    def span_enter(self, name: str) -> List:
        stack = getattr(self._span_stack, "stack", None)
        if stack is None:
            stack = self._span_stack.stack = []
        rec = [name, self._clock(), 0.0]  # [name, t0, child seconds]
        stack.append(rec)
        return rec

    def span_exit(self, rec: List) -> None:
        stack = getattr(self._span_stack, "stack", None)
        dur = self._clock() - rec[1]
        if stack and stack[-1] is rec:
            stack.pop()
        if stack:
            stack[-1][2] += dur
        self_time = max(0.0, dur - rec[2])
        with self._lock:
            name = rec[0]
            self._phase_total[name] = self._phase_total.get(name, 0.0) + self_time
            self._phase_interval[name] = self._phase_interval.get(name, 0.0) + self_time

    # -- interval math -----------------------------------------------------
    # The phase -> bucket map behind Telemetry/phase_pct/*: `env` is host
    # work driving the envs and the policy, `fetch` blocking waits on env
    # results and batch staging, `train` the gradient steps, everything else
    # `other`, and `idle` wall-clock no span accounted for.
    _PHASE_BUCKETS = {
        "rollout": "env",
        "env_step_async": "env",
        "env_wait": "fetch",
        "buffer-sample": "fetch",
        "train": "train",
    }

    def interval_metrics(self, step: Optional[float]) -> Dict[str, float]:
        """Close the current accounting interval and return its Telemetry/*
        gauges (the facade calls this once per aggregated-metrics interval)."""
        if not self.enabled:
            return {}
        now = self._clock()
        out: Dict[str, float] = {}
        with self._lock:
            dt = (now - self._tick_t) if self._tick_t is not None else 0.0
            if dt > 0:
                if step is not None and self._tick_step is not None and step >= self._tick_step:
                    out[TELEMETRY_PREFIX + "sps"] = (float(step) - self._tick_step) / dt
                if self._train_flops_interval > 0 and self.mfu_enabled:
                    flops_per_s = self._train_flops_interval / dt
                    out[TELEMETRY_PREFIX + "tflops_per_sec"] = flops_per_s / 1e12
                    if self._peak_flops_total:
                        out[TELEMETRY_PREFIX + "mfu"] = flops_per_s / self._peak_flops_total
                if self._env_steps_interval > 0:
                    out[TELEMETRY_PREFIX + "env_steps_per_sec"] = self._env_steps_interval / dt
                    if self._rollout_calls_interval > 0:
                        out[TELEMETRY_PREFIX + "fetch_amortization"] = (
                            self._env_steps_interval / self._rollout_calls_interval
                        )
                if self._dataset_rows_interval > 0:
                    out[TELEMETRY_PREFIX + "dataset_read_sps"] = self._dataset_rows_interval / dt
                if self._phase_interval:
                    buckets: Dict[str, float] = {}
                    for name, secs in self._phase_interval.items():
                        bucket = self._PHASE_BUCKETS.get(name, "other")
                        buckets[bucket] = buckets.get(bucket, 0.0) + secs
                    accounted = sum(buckets.values())
                    buckets["idle"] = max(0.0, dt - accounted)
                    for bucket, secs in sorted(buckets.items()):
                        out[TELEMETRY_PREFIX + f"phase_pct/{bucket}"] = 100.0 * secs / dt
            if self._dataset_epoch is not None:
                out[TELEMETRY_PREFIX + "dataset_epoch"] = self._dataset_epoch
            out[TELEMETRY_PREFIX + "recompiles"] = float(self._recompiles_total)
            out[TELEMETRY_PREFIX + "compile_count"] = float(self._backend_compiles)
            out[TELEMETRY_PREFIX + "compile_time_s"] = round(self._backend_compile_s, 3)
            self._phase_interval = {}
            self._calls_interval = {}
            self._train_flops_interval = 0.0
            self._env_steps_interval = 0
            self._rollout_calls_interval = 0
            self._dataset_rows_interval = 0
            self._tick_t = now
            if step is not None:
                self._tick_step = float(step)
            self._latest = dict(out)
        return out

    # -- snapshots (metrics server / run summary) --------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "info": dict(self._info),
                "gauges": dict(self._latest),
                "counters": {
                    "recompiles_total": self._recompiles_total,
                    "recompile_storms_total": self._storms_total,
                    "backend_compiles_total": self._backend_compiles,
                    "compile_seconds_total": round(self._backend_compile_s, 3),
                    "sentinel_events_total": self._sentinel_events,
                    "train_flops_total": self._train_flops_total,
                    "env_steps_total": self._env_steps_total,
                    "dataset_rows_read_total": self._dataset_rows_total,
                },
                "policy_steps": self._tick_step,
                "phase_seconds_total": dict(self._phase_total),
                "calls_total": dict(self._calls_total),
                "flops_per_call": {
                    name: inst.flops_per_call
                    for name, inst in self._instrumented.items()
                    if inst.flops_per_call
                },
            }

    def summary(self) -> Dict[str, Any]:
        """Cumulative run totals for the closing ``telemetry_summary`` event."""
        snap = self.snapshot()
        return {
            "recompiles": snap["counters"]["recompiles_total"],
            "recompile_storms": snap["counters"]["recompile_storms_total"],
            "backend_compiles": snap["counters"]["backend_compiles_total"],
            "compile_time_s": snap["counters"]["compile_seconds_total"],
            "train_flops_total": snap["counters"]["train_flops_total"],
            "phase_seconds": {k: round(v, 3) for k, v in snap["phase_seconds_total"].items()},
            "instrumented_calls": snap["calls_total"],
        }
