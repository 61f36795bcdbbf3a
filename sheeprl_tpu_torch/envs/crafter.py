"""Crafter adapter: counterpart of ``sheeprl_tpu/envs/crafter.py`` over the
port's spaces.  Crafter is an old-gym env (4-tuple step,
``info["discount"]``); this wraps it into the 5-tuple semantics with the
pixel observation under a Dict key ``rgb``.  ``id`` selects the reward
variant: ``crafter_reward`` or ``crafter_nonreward``.  Importing the module
raises ``ModuleNotFoundError`` where ``crafter`` is missing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.imports import _IS_CRAFTER_AVAILABLE

if not _IS_CRAFTER_AVAILABLE:
    raise ModuleNotFoundError("No module named 'crafter'")

import crafter  # noqa: E402

_VALID_IDS = ("crafter_reward", "crafter_nonreward")


class CrafterWrapper:
    metadata = {"render_modes": ["rgb_array"], "render_fps": 30}

    def __init__(self, id: str, screen_size: Union[int, Tuple[int, int]] = 64, seed: Optional[int] = None):
        if id not in _VALID_IDS:
            raise ValueError(f"Unknown crafter id {id!r}; expected one of {_VALID_IDS}")
        size = (screen_size, screen_size) if isinstance(screen_size, int) else tuple(screen_size)
        self._env = crafter.Env(size=size, seed=seed, reward=(id == "crafter_reward"))

        inner = self._env.observation_space
        self.observation_space = spaces.Dict(
            {"rgb": spaces.Box(inner.low, inner.high, inner.shape, inner.dtype)}
        )
        self.action_space = spaces.Discrete(self._env.action_space.n)
        self.reward_range = self._env.reward_range or (-np.inf, np.inf)
        self.render_mode = "rgb_array"
        self.observation_space.seed(seed)
        self.action_space.seed(seed)

    def step(self, action: Any) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        obs, reward, done, info = self._env.step(action)
        # crafter signals a true death with discount 0; discount 1 at done is
        # the 10k-step time limit (upstream sheeprl's crafter.py:51-53)
        terminated = done and info["discount"] == 0
        truncated = done and info["discount"] != 0
        return {"rgb": obs}, float(reward), terminated, truncated, info

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        self._env._seed = seed
        return {"rgb": self._env.reset()}, {}

    def render(self) -> Optional[np.ndarray]:
        return self._env.render()

    def close(self) -> None:
        pass
