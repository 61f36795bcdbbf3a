"""Optional-dependency gates (counterpart of ``sheeprl_tpu/utils/imports.py``):
whether a package is installed, asked of ``importlib.util.find_spec`` so
that nothing is imported.  The loggers and the model registry read these
flags where they would import the package, and tests stub a package by
setting its flag beside a fake module; each env backend's adapter raises
``ModuleNotFoundError`` on import where its flag is False."""

from __future__ import annotations

import importlib.util


def _available(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_IS_WANDB_AVAILABLE = _available("wandb")
_IS_MLFLOW_AVAILABLE = _available("mlflow")
_IS_ATARI_AVAILABLE = _available("ale_py")
_IS_DMC_AVAILABLE = _available("dm_control")
_IS_CRAFTER_AVAILABLE = _available("crafter")
_IS_DIAMBRA_AVAILABLE = _available("diambra")
_IS_MINEDOJO_AVAILABLE = _available("minedojo")
_IS_MINERL_AVAILABLE = _available("minerl")
_IS_SUPER_MARIO_AVAILABLE = _available("gym_super_mario_bros")
