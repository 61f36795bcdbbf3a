"""Run loggers and versioned log dirs (counterpart of
``sheeprl_tpu/utils/logger.py``).  TensorBoard is the default backend; W&B
and MLflow are still to port (ROADMAP.md Queue 1).  :class:`JournalingLogger`
mirrors every logged interval, with the ``Telemetry/*`` gauges merged in,
into the diagnostics journal; unlike the JAX package it does so with
``metric.logger=null`` too, so a run without TensorBoard keeps its record."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

_NOT_PORTED = "is not ported yet: see ROADMAP.md Queue 1; use the tensorboard logger or metric.logger=null"


class NoOpLogger:
    log_dir: Optional[str] = None
    name = "noop"

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        pass

    def finalize(self, status: str = "success") -> None:
        pass


class TensorBoardLogger(NoOpLogger):
    name = "tensorboard"

    def __init__(self, root_dir: str, name: str = "", **_: Any):
        self.log_dir = os.path.join(root_dir, name) if name else root_dir
        os.makedirs(self.log_dir, exist_ok=True)
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=self.log_dir)

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        for key, value in metrics.items():
            self._writer.add_scalar(key, float(value), global_step=step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        import yaml

        self._writer.add_text("hparams", "```yaml\n" + yaml.safe_dump(params) + "\n```")

    def finalize(self, status: str = "success") -> None:
        self._writer.flush()
        self._writer.close()


class WandbLogger(NoOpLogger):
    def __init__(self, **_: Any):
        raise NotImplementedError(f"the W&B logger {_NOT_PORTED}")


class MLFlowLogger(NoOpLogger):
    def __init__(self, **_: Any):
        raise NotImplementedError(f"the MLflow logger {_NOT_PORTED}")


def get_log_dir(runtime, root_dir: str, run_name: str) -> str:
    """``logs/runs/<root_dir>/<run_name>/version_N``, N one past the
    highest present (an absolute ``root_dir`` replaces ``logs/runs``)."""
    base = os.path.join("logs", "runs", root_dir, run_name)
    os.makedirs(base, exist_ok=True)
    versions = [int(d.split("_")[1]) for d in os.listdir(base) if d.startswith("version_") and d.split("_")[1].isdigit()]
    log_dir = os.path.join(base, f"version_{max(versions) + 1 if versions else 0}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


class JournalingLogger(NoOpLogger):
    """Proxy that merges the diagnostics' ``Telemetry/*`` gauges into every
    ``log_metrics`` call, hands it to the backend, then journals it.  The
    facade is looked up on the runtime at each call, since the logger
    exists before the run dir (and so the journal) does."""

    def __init__(self, inner: NoOpLogger, runtime):
        self._inner = inner
        self._runtime = runtime

    @property
    def log_dir(self):
        return self._inner.log_dir

    @property
    def name(self):
        return self._inner.name

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        diagnostics = getattr(self._runtime, "diagnostics", None)
        if diagnostics is not None:
            metrics = diagnostics.augment_metrics(step, metrics)
        self._inner.log_metrics(metrics, step)
        if diagnostics is not None:
            diagnostics.log_metrics(step, metrics)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        self._inner.log_hyperparams(params)

    def finalize(self, status: str = "success") -> None:
        self._inner.finalize(status)


def get_logger(runtime, cfg) -> NoOpLogger:
    """The configured logger behind the journaling proxy (a no-op backend
    with ``metric.logger=null``), or a no-op one at ``metric.log_level=0``."""
    from sheeprl_tpu_torch.config import instantiate

    if cfg.metric.get("log_level", 1) == 0:
        return NoOpLogger()
    inner = NoOpLogger() if cfg.metric.get("logger") is None else instantiate(dict(cfg.metric.logger))
    return JournalingLogger(inner, runtime)
