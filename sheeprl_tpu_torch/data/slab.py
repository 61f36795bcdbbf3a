"""The ``[1, num_envs, ...]`` step record of a replay write (counterpart of
``sheeprl_tpu/data/slab.py``: ``step_slab`` and ``rssm_state_slab``)."""

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


def rssm_state_slab(num_envs: int, recurrent: Any, stochastic: Any, valid: bool) -> Dict[str, Any]:
    """The ``[1, num_envs, ...]`` replay record of the player's post-step
    RSSM state (``algo.rssm_chunks > 1``, see
    ``algos/dreamer_v3/utils.py::RSSM_STATE_KEYS``).  ``recurrent`` and
    ``stochastic`` are ``[num_envs, H]`` and ``[num_envs, Z]``: numpy arrays
    pass as views, tensors stay on their device (the device ring writes them
    without a host round trip).  ``valid=False`` marks rows written without a
    player state (prefill, episode-end bookkeeping): a chunk whose initial
    state lands there resets to the learned initial state."""
    if recurrent.shape[0] != num_envs or stochastic.shape[0] != num_envs:
        raise ValueError(
            f"rssm_state_slab states must be [num_envs={num_envs}, ...], got "
            f"{tuple(recurrent.shape)} / {tuple(stochastic.shape)}"
        )
    return {
        "rssm_recurrent": recurrent[None],
        "rssm_posterior": stochastic[None],
        "rssm_valid": np.full((1, num_envs, 1), 1.0 if valid else 0.0, np.float32),
    }
