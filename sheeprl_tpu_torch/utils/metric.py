"""Metric aggregation (counterpart of ``sheeprl_tpu/utils/metric.py``): a
named registry of small host-side metrics with a global disable switch and
NaN filtering at compute time, and its rank-independent form, which gathers
every process's values through the runtime."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class MetricError(Exception):
    pass


class MeanMetric:
    # ``sync_on_compute`` and the other cross-process options of the configs
    # have nothing to do in a one-process run
    def __init__(self, **_: Any):
        self._values: List[float] = []

    def update(self, value: Any) -> None:
        self._values.append(float(value))

    def compute(self) -> float:
        return float(np.mean(self._values)) if self._values else float("nan")

    def reset(self) -> None:
        self._values = []


class SumMetric:
    """The sum of the values since the last reset (0 when none)."""

    def __init__(self, **_: Any):
        self._values: List[float] = []

    def update(self, value: Any) -> None:
        self._values.append(float(value))

    def compute(self) -> float:
        return float(np.sum(np.asarray(self._values, np.float64))) if self._values else 0.0

    def reset(self) -> None:
        self._values = []


class LastValueMetric:
    def __init__(self, **_: Any):
        self._value: Optional[float] = None

    def update(self, value: Any) -> None:
        self._value = float(value)

    def compute(self) -> float:
        return self._value if self._value is not None else float("nan")

    def reset(self) -> None:
        self._value = None


class MetricAggregator:
    """Named metrics; names not registered are dropped (or raise, with
    ``raise_on_missing``)."""

    disabled: bool = False

    def __init__(self, metrics: Optional[Dict[str, Any]] = None, raise_on_missing: bool = False):
        self.metrics: Dict[str, Any] = dict(metrics or {})
        self._raise_on_missing = raise_on_missing

    def update(self, name: str, value: Any) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            if self._raise_on_missing:
                raise MetricError(f"Unknown metric '{name}'")
            return
        self.metrics[name].update(value)

    def reset(self) -> None:
        for metric in self.metrics.values():
            metric.reset()

    def compute(self) -> Dict[str, float]:
        """Every metric's value, NaNs dropped."""
        if self.disabled:
            return {}
        out = {name: metric.compute() for name, metric in self.metrics.items()}
        return {k: v for k, v in out.items() if not np.isnan(v)}


class RankIndependentMetricAggregator:
    """A :class:`MetricAggregator` whose values stay per process: ``compute``
    gathers every process's through ``runtime.all_gather`` (the JAX
    package's, ``sheeprl_tpu/utils/metric.py``), each name mapped to the
    list of the ranks' values in rank order (one value with one process)."""

    def __init__(self, runtime: Any, metrics: Optional[Dict[str, Any]] = None):
        self._runtime = runtime
        self._aggregator = MetricAggregator(metrics)

    def update(self, name: str, value: Any) -> None:
        self._aggregator.update(name, value)

    def compute(self) -> Dict[str, List[float]]:
        local = self._aggregator.compute()
        if getattr(self._runtime, "process_count", 1) == 1:
            return {k: [v] for k, v in local.items()}
        gathered = self._runtime.all_gather(local)
        return {k: [float(x) for x in np.asarray(v).reshape(-1)] for k, v in gathered.items()}

    def reset(self) -> None:
        self._aggregator.reset()
