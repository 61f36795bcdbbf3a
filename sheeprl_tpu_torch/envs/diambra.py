"""DIAMBRA Arena adapter: counterpart of ``sheeprl_tpu/envs/diambra.py``
over the port's spaces.

DIAMBRA arcade envs return a Dict observation mixing Box frames with
Discrete/MultiDiscrete scalars; buffers store everything as arrays, so the
scalar sub-spaces are re-expressed as int32 Boxes and every observation value
is reshaped to its declared shape.  One player only; frame sizing is forced
through the engine (or the wrapper stack when ``increase_performance=False``).
Importing the module raises ``ModuleNotFoundError`` where ``diambra`` is
missing.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.env import _port_space

from sheeprl_tpu_torch.utils.imports import _IS_DIAMBRA_AVAILABLE

if not _IS_DIAMBRA_AVAILABLE:
    raise ModuleNotFoundError("No module named 'diambra'")

import diambra.arena  # noqa: E402

_ACTION_SPACES = {"DISCRETE", "MULTI_DISCRETE"}
# engine settings / wrapper options the adapter owns and callers may not override
_RESERVED_SETTINGS = ("frame_shape", "n_players")
_RESERVED_WRAPPERS = ("frame_shape", "stack_frames", "dilation", "flatten")


def boxify_space(space) -> spaces.Box:
    """A DIAMBRA (gymnasium) observation sub-space as the port's Box: a
    Discrete/MultiDiscrete one as an int32 Box, so that replay buffers store
    it as a dense array."""
    name = type(space).__name__
    if name == "Box":
        return spaces.Box(space.low, space.high, space.shape, space.dtype)
    if name == "Discrete":
        return spaces.Box(0, int(space.n) - 1, (1,), np.int32)
    if name == "MultiDiscrete":
        nvec = np.asarray(space.nvec)
        return spaces.Box(np.zeros_like(nvec), nvec - 1, (len(nvec),), np.int32)
    raise RuntimeError(f"Unsupported DIAMBRA observation sub-space: {type(space)}")


class DiambraWrapper:
    metadata = {"render_modes": ["rgb_array", "human"]}

    def __init__(
        self,
        id: str,
        action_space: str = "DISCRETE",
        screen_size: Union[int, Tuple[int, int]] = 64,
        grayscale: bool = False,
        repeat_action: int = 1,
        rank: int = 0,
        diambra_settings: Optional[Dict[str, Any]] = None,
        diambra_wrappers: Optional[Dict[str, Any]] = None,
        render_mode: str = "rgb_array",
        log_level: int = 0,
        increase_performance: bool = True,
    ) -> None:
        if action_space not in _ACTION_SPACES:
            raise ValueError(f"'action_space' must be one of {sorted(_ACTION_SPACES)}, got {action_space}")
        if isinstance(screen_size, int):
            screen_size = (screen_size, screen_size)
        settings_in = dict(diambra_settings or {})
        wrappers_in = dict(diambra_wrappers or {})
        for k in _RESERVED_SETTINGS:
            if settings_in.pop(k, None) is not None:
                warnings.warn(f"The DIAMBRA {k} setting is managed by the wrapper and was ignored")
        for k in _RESERVED_WRAPPERS:
            if wrappers_in.pop(k, None) is not None:
                warnings.warn(f"The DIAMBRA {k} wrapper option is managed by the wrapper and was ignored")
        role = settings_in.pop("role", None)
        if role is not None and role not in {"P1", "P2"}:
            raise ValueError(f"'role' must be 'P1', 'P2' or None, got {role}")

        settings = diambra.arena.EnvironmentSettings(
            **settings_in,
            game_id=id,
            action_space=getattr(diambra.arena.SpaceTypes, action_space),
            n_players=1,
            role=getattr(diambra.arena.Roles, role) if role is not None else None,
            render_mode=render_mode,
        )
        if repeat_action > 1:
            # sticky actions need the engine to run at its base step ratio
            if getattr(settings, "step_ratio", 1) > 1:
                warnings.warn(f"step_ratio forced to 1 because repeat_action={repeat_action}")
            settings.step_ratio = 1
        wrappers = diambra.arena.WrappersSettings(**wrappers_in, flatten=True, repeat_action=repeat_action)
        frame_shape = tuple(screen_size) + (int(grayscale),)
        if increase_performance:
            settings.frame_shape = frame_shape  # resize inside the engine
        else:
            wrappers.frame_shape = frame_shape  # resize in python

        self._env = diambra.arena.make(
            id, settings, wrappers, rank=rank, render_mode=render_mode, log_level=log_level
        )
        self._discrete_actions = action_space == "DISCRETE"
        self.action_space = _port_space(self._env.action_space)
        self.observation_space = spaces.Dict(
            {k: boxify_space(v) for k, v in self._env.observation_space.spaces.items()}
        )
        self.render_mode = render_mode

    def _as_arrays(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {
            k: np.asarray(v).reshape(self.observation_space[k].shape) for k, v in obs.items()
        }

    def step(self, action: Any) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        if self._discrete_actions and isinstance(action, np.ndarray):
            action = int(action.squeeze())
        obs, reward, terminated, truncated, info = self._env.step(action)
        info["env_domain"] = "DIAMBRA"
        # a finished game ends the episode even when the round continues
        terminated = terminated or bool(info.get("env_done", False))
        return self._as_arrays(obs), float(reward), terminated, truncated, info

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        obs, info = self._env.reset(seed=seed, options=options)
        info["env_domain"] = "DIAMBRA"
        return self._as_arrays(obs), info

    def render(self) -> Optional[np.ndarray]:
        return self._env.render()

    def close(self) -> None:
        self._env.close()
