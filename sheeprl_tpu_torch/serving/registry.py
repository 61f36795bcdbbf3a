"""The model registry: N resident policies in one server (counterpart of
``sheeprl_tpu/serving/registry.py``).

One :class:`~sheeprl_tpu_torch.serving.server.ServeApp` can hold several
policies (a canary next to the stable one), each with its own service
(modules, per-bucket steps, batcher, session slab), request log and
checkpoint watcher with its health gate, all journaling into the one serving
journal with a ``model`` field.  ``/act`` routes on the request's ``model``
field (absent: the default model); ``/metrics`` renders every
``sheeprl_serve_*`` / ``sheeprl_sessions_*`` family per model
(``{model="..."}``) and as an unlabeled aggregate.

Requests to different models never share a dispatch: they run different
modules.  What they share is the process, the card and the journal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from sheeprl_tpu_torch.diagnostics.metrics_server import _escape_label, _metric_name, latency_histogram_lines
from sheeprl_tpu_torch.diagnostics.schema import METRIC_PREFIX
from sheeprl_tpu_torch.serving.batcher import ServeError

__all__ = ["ModelEntry", "ModelRegistry", "render_registry_metrics"]


@dataclass
class ModelEntry:
    """Everything one resident model owns."""

    name: str
    service: Any  # PolicyService
    handle: Any  # PolicyHandle
    watcher: Any = None  # Optional[CheckpointWatcher]
    request_log: Any = None  # Optional[RequestLog]
    meta: Dict[str, Any] = field(default_factory=dict)


class ModelRegistry:
    """Name -> :class:`ModelEntry`, with a default for model-less requests."""

    def __init__(self) -> None:
        self._entries: Dict[str, ModelEntry] = {}
        self.default_name: Optional[str] = None

    def add(self, entry: ModelEntry, default: bool = False) -> ModelEntry:
        if entry.name in self._entries:
            raise ValueError(f"model {entry.name!r} is already registered")
        self._entries[entry.name] = entry
        if default or self.default_name is None:
            self.default_name = entry.name
        return entry

    def get(self, name: Optional[str] = None) -> ModelEntry:
        key = str(name) if name else self.default_name
        entry = self._entries.get(key) if key else None
        if entry is None:
            raise ServeError(404, f"unknown model {name!r}; resident models: {sorted(self._entries)}")
        return entry

    def names(self) -> List[str]:
        return sorted(self._entries)

    def entries(self) -> List[ModelEntry]:
        return [self._entries[n] for n in self.names()]

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    @property
    def default(self) -> ModelEntry:
        return self.get(None)


#: gauge families whose unlabeled aggregate sums across models; the rest
#: aggregate by max (latencies: the worst model is the honest headline)
_SUM_GAUGES = {"serve_queue_depth", "serve_requests_per_sec", "sessions_active", "sessions_capacity"}


def _num(value: Any) -> Optional[float]:
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def render_registry_metrics(registry: ModelRegistry) -> str:
    """Prometheus text for every resident model: one ``# TYPE`` line per
    family, then the ``{model="..."}`` series, then the unlabeled aggregate
    last, so a parser that keeps the last value reads the fleet total."""
    snaps = {e.name: e.service.snapshot() for e in registry.entries()}
    default_snap = snaps.get(registry.default_name) or next(iter(snaps.values()), {})
    lines: List[str] = []

    info = dict(default_snap.get("info") or {})
    info["models"] = ",".join(registry.names())
    lines.append("# HELP sheeprl_run_info Run identity (labels carry the data; value is 1).")
    lines.append("# TYPE sheeprl_run_info gauge")
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(info.items()) if v is not None)
    lines.append(f"sheeprl_run_info{{{inner}}} 1")
    lines.append("# TYPE sheeprl_up gauge")
    lines.append("sheeprl_up 1")
    lines.append("# TYPE sheeprl_serve_models gauge")
    lines.append(f"sheeprl_serve_models {len(registry)}")

    def family(kind: str, name: str, per_model: Dict[str, float], aggregate: float) -> None:
        full = METRIC_PREFIX + name
        lines.append(f"# TYPE {full} {kind}")
        for model in sorted(per_model):
            lines.append(f'{full}{{model="{_escape_label(model)}"}} {per_model[model]:g}')
        lines.append(f"{full} {aggregate:g}")

    gauge_values: Dict[str, Dict[str, float]] = {}
    for model, snap in snaps.items():
        for key, value in (snap.get("gauges") or {}).items():
            num = _num(value)
            if num is not None:
                gauge_values.setdefault(_metric_name(key), {})[model] = num
    for name in sorted(gauge_values):
        per_model = gauge_values[name]
        if name == "serve_ckpt_step":
            aggregate = per_model.get(registry.default_name, max(per_model.values()))
        elif name in _SUM_GAUGES:
            aggregate = sum(per_model.values())
        else:
            aggregate = max(per_model.values())
        family("gauge", name, per_model, aggregate)

    counter_values: Dict[str, Dict[str, float]] = {}
    for model, snap in snaps.items():
        for key, value in (snap.get("counters") or {}).items():
            num = _num(value)
            if num is not None:
                counter_values.setdefault(key, {})[model] = num
    for name in sorted(counter_values):
        family("counter", name, counter_values[name], sum(counter_values[name].values()))

    # the batch-width histogram: {model, width} series + width-only aggregate
    width_totals: Dict[int, float] = {}
    width_lines: List[str] = []
    for model in sorted(snaps):
        for width, count in sorted((snaps[model].get("batch_width_hist") or {}).items()):
            width_lines.append(
                f'sheeprl_serve_batch_width_total{{model="{_escape_label(model)}",width="{int(width)}"}} {int(count)}'
            )
            width_totals[int(width)] = width_totals.get(int(width), 0) + int(count)
    if width_lines:
        lines.append("# TYPE sheeprl_serve_batch_width_total counter")
        lines.extend(width_lines)
        for width, count in sorted(width_totals.items()):
            lines.append(f'sheeprl_serve_batch_width_total{{width="{width}"}} {count:g}')

    # the per-phase latency histogram: {model, phase, le} series + the
    # unlabeled {phase, le} aggregate (the bucket bounds come from config,
    # so cumulative counts sum across models without re-binning)
    agg: Dict[str, Dict[str, Any]] = {}
    hist_lines: List[str] = []
    for model in sorted(snaps):
        hist = snaps[model].get("latency_hist") or {}
        hist_lines.extend(latency_histogram_lines(hist, model=model))
        for phase, entry in hist.items():
            slot = agg.setdefault(phase, {"buckets": {}, "sum": 0.0, "count": 0})
            for le, count in entry.get("buckets") or []:
                key = str(le)
                slot["buckets"][key] = (le, slot["buckets"].get(key, (le, 0))[1] + count)
            slot["sum"] += float(entry.get("sum") or 0.0)
            slot["count"] += int(entry.get("count") or 0)
    if hist_lines:
        lines.append("# TYPE sheeprl_serve_latency_ms histogram")
        lines.extend(hist_lines)
        if len(snaps) > 1:
            lines.extend(latency_histogram_lines({
                phase: {"buckets": list(slot["buckets"].values()), "sum": slot["sum"], "count": slot["count"]}
                for phase, slot in agg.items()
            }))
        else:
            # one model: its series again, unlabeled, for tooling without labels
            lines.extend(latency_histogram_lines(next(iter(snaps.values()), {}).get("latency_hist") or {}))
    return "\n".join(lines) + "\n"
