"""Optional-dependency gates (counterpart of ``sheeprl_tpu/utils/imports.py``):
whether a package is installed, asked of ``importlib.util.find_spec`` so
that nothing is imported.  The loggers and the model registry read these
flags where they would import the package, and tests stub a package by
setting its flag beside a fake module; the env backends still to port add
theirs (ROADMAP.md Queue 1)."""

from __future__ import annotations

import importlib.util


def _available(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_IS_WANDB_AVAILABLE = _available("wandb")
_IS_MLFLOW_AVAILABLE = _available("mlflow")
