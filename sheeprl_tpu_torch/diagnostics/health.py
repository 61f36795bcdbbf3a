"""Learning-dynamics observability (counterpart of
``sheeprl_tpu/diagnostics/health.py``): train-health statistics computed
inside the gradient step, and host-side anomaly detectors.

* **In the step, no extra sync**: :func:`health_stats` computes the global
  and per-module gradient, update and parameter norms, the update-to-weight
  ratio and the dead-unit fraction from the step's own tensors.  The
  DreamerV3 step stacks them onto its metric vector, so they reach the host
  with the log interval's one fetch.  The norms use ``torch._foreach_norm``
  (a few launches for all of a tree's tensors), the dead units one ``amax``
  per tensor and one compare over all units.
* **On the host**: :class:`HealthMonitor` keeps rolling windows over the
  per-step stats (``diag.on_health``) and the aggregated metric stream
  (entropy collapse, update-ratio band, loss plateau, dead gradients); a
  breach held for ``confirm`` consecutive observations journals one fsync'd
  ``anomaly``, recovery ``anomaly_end``.  The ``Telemetry/health/*`` gauges
  ride every metric interval and ``/metrics``.

A *unit* is what the JAX package counts: a slice along the last axis of a
flax leaf (a Dense or Conv output feature, a ConvTranspose output channel,
each element of a bias, scale or other 1-D leaf).  A torch tensor holds it
on another axis: ``Linear.weight[out, in]`` and Conv ``[O, I, kh, kw]`` on
dim 0, ConvTranspose ``[in, out, kh, kw]`` on dim 1 (:func:`unit_dim`, from
the weight converter's layout kinds in ``interop/flax_params.py``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch


class HealthSpec(NamedTuple):
    """The health stats' configuration, read once by ``make_train_step``."""

    enabled: bool = False
    per_module: bool = False
    dead_eps: float = 1e-8


def health_spec(cfg: Mapping[str, Any]) -> HealthSpec:
    """The :class:`HealthSpec` of a composed run config; a config without a
    ``diagnostics`` section means disabled."""
    diag = cfg.get("diagnostics") or {}
    health = diag.get("health") or {}
    enabled = bool(diag.get("enabled", False)) and bool(health.get("enabled", True))
    return HealthSpec(
        enabled=enabled,
        per_module=bool(health.get("per_module", False)),
        dead_eps=float(health.get("dead_eps", 1e-8)),
    )


#: the weight converter's layout kind -> the torch axis of a flax leaf's
#: last axis (``same``: the layouts agree, so the last axis)
_UNIT_DIM = {"dense": 0, "dense_nhwc": 0, "dense_to_hwc": 0, "conv": 0, "conv_transpose": 1}


def unit_dim(kind: str, ndim: int) -> int:
    """The axis of a torch tensor whose slices are the JAX package's units,
    for a tensor of layout ``kind`` (``interop/flax_params.py``)."""
    return _UNIT_DIM.get(kind, ndim - 1)


def top_level_modules(tree: Any) -> Dict[str, Any]:
    """Group a parameter-like pytree by its top-level module names.

    Descends through single-key mappings first (flax's ``{"params": {...}}``
    wrapper must not collapse everything into one "params" module) and groups
    by the keys of the first multi-key mapping.  A non-mapping tree (or a
    mapping of leaves) grouped as a single ``all`` module keeps the helper
    total on exotic structures.
    """
    node = tree
    while isinstance(node, Mapping) and len(node) == 1:
        (only,) = node.values()
        if not isinstance(only, Mapping):
            break
        node = only
    if isinstance(node, Mapping) and len(node) > 1:
        return {str(k): node[k] for k in node}
    return {"all": node}


def _unit_magnitudes(grads: Sequence[torch.Tensor], dims: Sequence[int]) -> List[torch.Tensor]:
    """Per tensor, the max ``|grad|`` of each unit, as a 1-D tensor."""
    mags = []
    for g, dim in zip(torch._foreach_abs(list(grads)), dims):
        if g.dim() == 0:
            mags.append(g.reshape(1))
        elif g.dim() == 1:
            mags.append(g)
        else:
            mags.append(g.amax(dim=[d for d in range(g.dim()) if d != dim]))
    return mags


def _unit_counts(grads: Sequence[torch.Tensor], dims: Sequence[int], dead_eps: float) -> Tuple[torch.Tensor, int]:
    """(dead units as a 0-d float32 tensor, total units) over a list of
    gradients, ``dims[i]`` the unit axis of ``grads[i]``: a unit is dead
    when the max ``|grad|`` over its slice is ``<= dead_eps``."""
    mags = _unit_magnitudes(grads, dims)
    if not mags:
        return torch.zeros(()), 0
    units = torch.cat([m.float() for m in mags])
    return (units <= dead_eps).float().sum(), int(units.numel())


def _norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of each tensor, stacked."""
    return torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float32))


@torch.no_grad()
def health_stats(
    grads: Mapping[str, Sequence[torch.Tensor]],
    updates: Mapping[str, Sequence[torch.Tensor]],
    params: Mapping[str, Sequence[torch.Tensor]],
    *,
    unit_dims: Optional[Mapping[str, Sequence[int]]] = None,
    per_module: bool = False,
    dead_eps: float = 1e-8,
) -> Dict[str, torch.Tensor]:
    """Train-health statistics over top-level modules, as 0-d tensors on
    the tensors' device (nothing waits for the host).

    ``grads``, ``updates`` and ``params`` map each module name to its
    tensors, in one order; ``unit_dims`` gives each tensor's unit axis
    (default: the last).  Returns, as the JAX ``health_stats`` does:

    * ``grad_norm`` / ``update_norm`` / ``param_norm``: global L2 norms over
      all modules (``grad_norm`` is ``optax.global_norm`` of the gradients);
    * ``update_ratio``: ``update_norm / (param_norm + 1e-12)``;
    * ``dead_frac``: the share of units whose max ``|grad|`` is
      ``<= dead_eps``;
    * ``module/<name>/<stat>``: the same five per module when
      ``per_module``.
    """
    names = list(grads)
    flat_g = [t for n in names for t in grads[n]]
    flat_u = [t for n in names for t in updates[n]]
    flat_p = [t for n in names for t in params[n]]
    dims = [d for n in names for d in (unit_dims[n] if unit_dims else [t.dim() - 1 for t in grads[n]])]
    g_sq, u_sq, p_sq = (_norms(ts).square() for ts in (flat_g, flat_u, flat_p))
    mags = [m.float() for m in _unit_magnitudes(flat_g, dims)]
    dead_units = torch.cat(mags) <= dead_eps
    eps = 1e-12

    def stats_of(a: int, b: int, ua: int, ub: int) -> Dict[str, torch.Tensor]:
        grad_norm, update_norm, param_norm = (sq[a:b].sum().sqrt() for sq in (g_sq, u_sq, p_sq))
        return {
            "grad_norm": grad_norm,
            "update_norm": update_norm,
            "param_norm": param_norm,
            "update_ratio": update_norm / (param_norm + eps),
            "dead_frac": dead_units[ua:ub].float().sum() / max(1, ub - ua),
        }

    out = stats_of(0, len(flat_g), 0, int(dead_units.numel()))
    if per_module:
        a = ua = 0
        for name in names:
            b = a + len(grads[name])
            ub = ua + sum(int(m.numel()) for m in mags[a:b])
            for stat, value in stats_of(a, b, ua, ub).items():
                out[f"module/{name}/{stat}"] = value
            a, ua = b, ub
    return out


def health_names(modules: Sequence[str], per_module: bool) -> List[str]:
    """The keys :func:`health_stats` returns, in its order."""
    stats = ("grad_norm", "update_norm", "param_norm", "update_ratio", "dead_frac")
    names = list(stats)
    if per_module:
        names += [f"module/{m}/{s}" for m in modules for s in stats]
    return names


def explained_variance(values: torch.Tensor, returns: torch.Tensor) -> torch.Tensor:
    """Value-function explained variance ``1 - Var(returns - values) /
    Var(returns)`` (0 when the return variance vanishes); population
    variances, as ``jnp.var``."""
    values = values.float().reshape(-1)
    returns = returns.float().reshape(-1)
    var_returns = returns.var(unbiased=False)
    safe = torch.where(var_returns > 1e-12, var_returns, torch.ones_like(var_returns))
    ev = 1.0 - (returns - values).var(unbiased=False) / safe
    return torch.where(var_returns > 1e-12, ev, torch.zeros_like(ev))


def mean_stats(stats_list: Sequence[Optional[Mapping[str, Any]]]) -> Dict[str, float]:
    """Key-wise mean over a sequence of fetched stats dicts (Dreamer's drain
    hands the per-gradient-step dicts of one log interval here).  ``None`` /
    empty entries are skipped; values coerce through ``float``."""
    sums: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for stats in stats_list:
        if not stats:
            continue
        for key, value in stats.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            sums[key] = sums.get(key, 0.0) + v
            counts[key] = counts.get(key, 0) + 1
    return {k: sums[k] / counts[k] for k in sums}


# ---------------------------------------------------------------------------
# host-side anomaly detection
# ---------------------------------------------------------------------------

#: Gauge-key prefix for everything this module merges into the metric stream.
HEALTH_PREFIX = "Telemetry/health/"
#: Scalar-subset gauge keys (registered in schema.METRICS; per-module detail
#: keys are built dynamically and stay journal/TensorBoard-only).
_SCALAR_GAUGES = ("grad_norm", "update_norm", "param_norm", "update_ratio", "dead_frac", "value_ev")


class HealthMonitor:
    """Rolling-window learning-health anomaly detection behind the facade.

    Opened on rank 0 only (its outputs are the journal and the gauges); every
    hook is a cheap no-op until then.  Two feeds:

    * :meth:`on_stats` — per-train-dispatch stats fetched by the loops
      (update/weight ratio, dead fractions, value EV);
    * :meth:`observe_metrics` — the aggregated metric stream at each log
      boundary (entropy collapse, loss plateau).

    A detector must breach for ``confirm`` consecutive observations before
    its single fsync'd ``anomaly`` event (flood control: one per detector
    while the condition holds); the first clean observation journals
    ``anomaly_end``.  Thread-safe: the metrics server snapshots from its own
    thread.
    """

    #: how many recent observations each journaled anomaly window carries
    WINDOW_KEEP = 12

    def __init__(self, cfg: Optional[Mapping[str, Any]]):
        cfg = cfg or {}
        diag_cfg = cfg.get("diagnostics") or {}
        health_cfg = diag_cfg.get("health") or {}
        self.enabled = bool(health_cfg.get("enabled", True))
        self.per_module = bool(health_cfg.get("per_module", False))
        self.confirm = int(health_cfg.get("confirm", 3))
        if self.confirm < 1:
            raise ValueError(
                f"diagnostics.health.confirm must be >= 1, got {health_cfg.get('confirm')!r}"
            )
        det = health_cfg.get("detectors") or {}
        self.entropy_key = det.get("entropy_key", "Loss/entropy_loss")
        floor = det.get("entropy_floor")
        self.entropy_floor = None if floor is None else float(floor)
        ev_floor = det.get("value_ev_floor")
        self.value_ev_floor = None if ev_floor is None else float(ev_floor)
        low = det.get("update_ratio_low", 1e-8)
        high = det.get("update_ratio_high", 1.0)
        self.update_ratio_low = None if low is None else float(low)
        self.update_ratio_high = None if high is None else float(high)
        if (
            self.update_ratio_low is not None
            and self.update_ratio_high is not None
            and self.update_ratio_low >= self.update_ratio_high
        ):
            raise ValueError(
                "diagnostics.health.detectors.update_ratio_low must be < update_ratio_high, "
                f"got {low!r} >= {high!r}"
            )
        dead_max = det.get("dead_frac_max", 0.95)
        self.dead_frac_max = None if dead_max is None else float(dead_max)
        self.plateau_key = det.get("plateau_key")
        self.plateau_window = int(det.get("plateau_window", 20))
        if self.plateau_window < 2:
            raise ValueError(
                f"diagnostics.health.detectors.plateau_window must be >= 2, "
                f"got {det.get('plateau_window')!r}"
            )
        rtol = det.get("plateau_rtol", 1e-3)
        self.plateau_rtol = None if rtol is None else float(rtol)
        inject = health_cfg.get("inject_entropy_collapse_iter")
        self.inject_entropy_collapse_iter = None if inject is None else int(inject)
        if self.enabled and self.inject_entropy_collapse_iter is not None and self.entropy_floor is None:
            # the drill forces the watched metric to 0, but the detector only
            # observes it when a floor is armed — an injection that cannot
            # fire must fail loudly, not journal a fault_injection event that
            # falsely validates the alerting chain
            raise ValueError(
                "diagnostics.health.inject_entropy_collapse_iter is set but "
                "diagnostics.health.detectors.entropy_floor is null — the entropy-collapse "
                "detector is disarmed and the drill could never fire; set a floor "
                "(e.g. detectors.entropy_floor=0.05)"
            )

        self._lock = threading.Lock()
        self._journal_fn: Optional[Callable[..., None]] = None
        self._sync_fn: Optional[Callable[[], None]] = None
        self._opened = False
        self._latest: Dict[str, float] = {}
        # per-detector state, keyed (kind, subject)
        self._windows: Dict[Tuple[str, str], deque] = {}
        self._breaches: Dict[Tuple[str, str], int] = {}
        self._active: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._anomalies_total = 0
        self._observe_calls = 0
        self._injecting = False

    # -- lifecycle ---------------------------------------------------------
    def open(
        self,
        journal_fn: Optional[Callable[..., None]] = None,
        sync_fn: Optional[Callable[[], None]] = None,
    ) -> None:
        if self._opened:
            return
        self._journal_fn = journal_fn
        self._sync_fn = sync_fn
        self._opened = True

    def _journal(self, event: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(event, **fields)

    # -- detector core ------------------------------------------------------
    def _observe_value(
        self,
        kind: str,
        subject: str,
        value: float,
        breach: bool,
        step: Optional[int],
        required: Optional[int] = None,
        window: Optional[deque] = None,
        **payload: Any,
    ) -> None:
        """One observation of one watched series (caller holds the lock).

        Journals the flood-controlled ``anomaly`` (fsync'd, with the
        offending window) after ``required`` consecutive breaches (default:
        the configured ``confirm``), and ``anomaly_end`` on the first clean
        observation while active.  A caller that maintains its own window
        (the plateau detector, whose window IS the confirmation) passes it
        in; otherwise a per-key recent-values deque is kept here.
        """
        key = (kind, subject)
        if window is None:
            window = self._windows.setdefault(key, deque(maxlen=self.WINDOW_KEEP))
            window.append(round(float(value), 6))
        required = self.confirm if required is None else required
        if breach:
            self._breaches[key] = self._breaches.get(key, 0) + 1
            if key not in self._active and self._breaches[key] >= required:
                self._active[key] = {"since_step": step}
                self._anomalies_total += 1
                self._journal(
                    "anomaly",
                    kind=kind,
                    subject=subject,
                    step=step,
                    value=round(float(value), 6),
                    window=list(window),
                    confirm=required,
                    **payload,
                )
                if self._sync_fn is not None:
                    # the whole point is catching a run that dies wastefully:
                    # the record must survive a SIGKILL right after it fires
                    self._sync_fn()
        else:
            self._breaches[key] = 0
            if key in self._active:
                since = self._active.pop(key).get("since_step")
                self._journal(
                    "anomaly_end",
                    kind=kind,
                    subject=subject,
                    step=step,
                    since_step=since,
                    value=round(float(value), 6),
                )

    # -- feeds --------------------------------------------------------------
    def on_stats(self, step: Optional[int], stats: Mapping[str, Any]) -> None:
        """Digest one fetched train-step stats dict (from ``health_stats``)."""
        if not self._opened or not stats:
            return
        clean: Dict[str, float] = {}
        for key, value in stats.items():
            try:
                clean[str(key)] = float(value)
            except (TypeError, ValueError):
                continue
        if not clean:
            return
        with self._lock:
            self._latest.update(clean)
            ratio = clean.get("update_ratio")
            if ratio is not None and (
                self.update_ratio_low is not None or self.update_ratio_high is not None
            ):
                low_breach = self.update_ratio_low is not None and ratio < self.update_ratio_low
                high_breach = self.update_ratio_high is not None and ratio > self.update_ratio_high
                self._observe_value(
                    "update_ratio_band",
                    "update_ratio",
                    ratio,
                    low_breach or high_breach,
                    step,
                    low=self.update_ratio_low,
                    high=self.update_ratio_high,
                )
            if self.dead_frac_max is not None:
                for key, value in clean.items():
                    if key == "dead_frac":
                        subject = "dead_frac"
                    elif key.startswith("module/") and key.endswith("/dead_frac"):
                        subject = key
                    else:
                        continue
                    self._observe_value(
                        "dead_gradient",
                        subject,
                        value,
                        value >= self.dead_frac_max,
                        step,
                        max=self.dead_frac_max,
                    )
            ev = clean.get("value_ev")
            if ev is not None and self.value_ev_floor is not None:
                self._observe_value(
                    "value_ev_floor",
                    "value_ev",
                    ev,
                    ev < self.value_ev_floor,
                    step,
                    floor=self.value_ev_floor,
                )

    def observe_metrics(self, step: Optional[int], metrics: Mapping[str, Any]) -> None:
        """Digest one aggregated-metrics interval (called at every log
        boundary, after the gauges were merged)."""
        if not self._opened:
            return
        import numpy as np

        with self._lock:
            self._observe_calls += 1
            call = self._observe_calls
            inject = (
                self.inject_entropy_collapse_iter is not None
                and self.inject_entropy_collapse_iter <= call
                < self.inject_entropy_collapse_iter + self.confirm
            )
            if inject and not self._injecting:
                self._injecting = True
                self._journal(
                    "fault_injection",
                    iter_num=call,
                    kind="entropy_collapse",
                    intervals=self.confirm,
                )
            if self.entropy_key and self.entropy_floor is not None:
                value = metrics.get(self.entropy_key)
                if inject:
                    value = 0.0
                if isinstance(value, (int, float)) and np.isfinite(float(value)):
                    # magnitude floor: collapse drives both true-entropy and
                    # negative-entropy (Loss/entropy_loss) metrics toward 0
                    self._observe_value(
                        "entropy_collapse",
                        self.entropy_key,
                        float(value),
                        abs(float(value)) < abs(self.entropy_floor),
                        step,
                        floor=self.entropy_floor,
                    )
            if self.plateau_key and self.plateau_rtol is not None:
                value = metrics.get(self.plateau_key)
                if isinstance(value, (int, float)) and np.isfinite(float(value)):
                    key = ("loss_plateau", str(self.plateau_key))
                    window = self._windows.setdefault(key, deque(maxlen=self.plateau_window))
                    window.append(round(float(value), 6))
                    full = len(window) == self.plateau_window
                    scale = max(float(np.median(np.abs(np.asarray(window)))), 1e-12)
                    spread = (max(window) - min(window)) / scale if full else float("inf")
                    # the plateau window IS the confirmation window (breach =
                    # "the last plateau_window values moved < rtol"), so one
                    # breaching observation fires: required=1
                    self._observe_value(
                        "loss_plateau",
                        str(self.plateau_key),
                        float(value),
                        full and spread < self.plateau_rtol,
                        step,
                        required=1,
                        window=window,
                        rtol=self.plateau_rtol,
                        spread=round(spread, 8) if full else None,
                    )

    def open_anomaly_kinds(self) -> List[str]:
        """Sorted kinds of the currently-active anomalies (the decoupled
        promotion gate's "open sentinel anomaly" veto signal — cheap enough
        to consult once per trainer iteration)."""
        if not self._opened:
            return []
        with self._lock:
            return sorted({kind for kind, _subject in self._active})

    # -- gauges / snapshots --------------------------------------------------
    def interval_metrics(self) -> Dict[str, float]:
        """The ``Telemetry/health/*`` gauges merged into every metric
        interval: the latest stats (per-module detail included when the spec
        collects it) plus the live active-anomaly count."""
        if not self._opened:
            return {}
        with self._lock:
            if not self._latest and not self._anomalies_total:
                return {}
            out = {HEALTH_PREFIX + k: v for k, v in self._latest.items()}
            out[HEALTH_PREFIX + "anomalies"] = float(len(self._active))
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The fixed scalar subset for ``/metrics`` (per-module detail stays
        journal/TB-only: Prometheus series must come from the registered
        vocabulary — see ``schema.METRICS``)."""
        with self._lock:
            gauges: Dict[str, float] = {}
            for stat in _SCALAR_GAUGES:
                if stat in self._latest:
                    gauges[HEALTH_PREFIX + stat] = self._latest[stat]
            gauges[HEALTH_PREFIX + "anomalies"] = float(len(self._active))
            counters = {"health_anomalies_total": self._anomalies_total}
            active = ",".join(sorted(f"{kind}:{subject}" for kind, subject in self._active))
            info = {"health_active_anomalies": active or None}
        return {"gauges": gauges, "counters": counters, "info": info}

    def summary(self) -> Dict[str, Any]:
        """Run totals folded into the closing ``telemetry_summary`` event."""
        with self._lock:
            return {
                "health_anomalies": self._anomalies_total,
                "health_anomalies_open": len(self._active),
            }
