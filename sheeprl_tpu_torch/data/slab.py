"""The ``[1, num_envs, ...]`` step record of a replay write (counterpart of
``sheeprl_tpu/data/slab.py::step_slab``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np


def step_slab(
    num_envs: int,
    arrays: Mapping[str, Any],
    dtypes: Optional[Mapping[str, Any]] = None,
) -> Dict[str, np.ndarray]:
    """One view (or dtype-cast copy) per key: ``[N] -> [1, N, 1]``,
    ``[N, ...] -> [1, N, ...]``.  Raises on a leading dim other than
    ``num_envs``, which would otherwise write garbage rows."""
    out: Dict[str, np.ndarray] = {}
    for key, value in arrays.items():
        arr = np.asarray(value, dtype=dtypes.get(key) if dtypes else None)
        if arr.ndim == 0 or arr.shape[0] != num_envs:
            raise ValueError(f"step_slab key '{key}' must be [num_envs={num_envs}, ...], got shape {arr.shape}")
        if arr.ndim == 1:
            arr = arr.reshape(num_envs, 1)
        out[key] = arr[np.newaxis]
    return out
