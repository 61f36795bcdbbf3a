"""Super Mario Bros adapter: counterpart of
``sheeprl_tpu/envs/super_mario_bros.py`` over the port's spaces.

gym-super-mario-bros is an old-gym NES emulator env; this adapter binds one of
the three canonical joypad action sets and exposes the 5-tuple semantics with
the frame under Dict key ``rgb``.  The NES ``info["time"]`` clock tells
running out of time (truncation) from death or the flag (termination).
Importing the module raises ``ModuleNotFoundError`` where
``gym_super_mario_bros`` is missing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.imports import _IS_SUPER_MARIO_AVAILABLE

if not _IS_SUPER_MARIO_AVAILABLE:
    raise ModuleNotFoundError("No module named 'gym_super_mario_bros'")

import gym_super_mario_bros  # noqa: E402
from gym_super_mario_bros import actions as smb_actions  # noqa: E402
from nes_py.wrappers import JoypadSpace  # noqa: E402

ACTION_SETS = {
    "right_only": smb_actions.RIGHT_ONLY,
    "simple": smb_actions.SIMPLE_MOVEMENT,
    "complex": smb_actions.COMPLEX_MOVEMENT,
}


class SuperMarioBrosWrapper:
    metadata = {"render_modes": ["rgb_array", "human"]}

    def __init__(self, id: str, action_space: str = "simple", render_mode: str = "rgb_array"):
        if action_space not in ACTION_SETS:
            raise ValueError(f"Unknown action set {action_space!r}; expected one of {sorted(ACTION_SETS)}")
        inner = gym_super_mario_bros.make(id)
        self._env = JoypadSpace(inner, ACTION_SETS[action_space])
        self.render_mode = render_mode

        frame_space = inner.observation_space
        self.observation_space = spaces.Dict(
            {"rgb": spaces.Box(frame_space.low, frame_space.high, frame_space.shape, frame_space.dtype)}
        )
        self.action_space = spaces.Discrete(self._env.action_space.n)

    def step(self, action: Any) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        if isinstance(action, np.ndarray):
            action = int(action.squeeze())
        obs, reward, done, info = self._env.step(action)
        # time==0 means the NES clock expired: a truncation, not a real
        # terminal state.  (Upstream sheeprl's wrapper tests `bool(info["time"])`,
        # super_mario_bros.py:58, which inverts this — deliberate fix.)
        out_of_time = info.get("time", 1) == 0
        return {"rgb": obs.copy()}, float(reward), done and not out_of_time, done and out_of_time, info

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        # JoypadSpace predates the seeded reset signature; call the wrapped env
        obs = self._env.env.reset(seed=seed, options=options)
        return {"rgb": np.asarray(obs).copy()}, {}

    def render(self) -> Optional[np.ndarray]:
        frame = self._env.render(mode=self.render_mode)
        if self.render_mode == "rgb_array" and frame is not None:
            return np.asarray(frame).copy()
        return None

    def close(self) -> None:
        self._env.close()
