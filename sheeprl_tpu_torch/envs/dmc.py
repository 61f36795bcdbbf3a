"""DeepMind Control Suite adapter: counterpart of ``sheeprl_tpu/envs/dmc.py``
over the port's spaces (``envs/spaces.py``), with no gymnasium.

One ``dm_control.suite`` task with a normalized [-1, 1] action space, pixel
and/or vector observations under a Dict space, and dm_env discount semantics
mapped onto the terminated/truncated split.  The spec and observation
conversions are pure module functions.  Importing the module raises
``ModuleNotFoundError`` where ``dm_control`` is missing, as the JAX
package's does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.imports import _IS_DMC_AVAILABLE

if not _IS_DMC_AVAILABLE:
    raise ModuleNotFoundError("No module named 'dm_control'")

from dm_control import suite  # noqa: E402
from dm_env import specs  # noqa: E402


def specs_to_box(spec_list: Iterable[Any], dtype=np.float32) -> spaces.Box:
    """Concatenate a sequence of dm_env array specs into one flat Box.

    Unbounded `Array` specs become (-inf, inf); `BoundedArray` keeps its
    bounds, broadcast to the flattened length.
    """
    lows, highs = [], []
    for s in spec_list:
        n = int(np.prod(s.shape)) if s.shape else 1
        if isinstance(s, specs.BoundedArray):
            lows.append(np.broadcast_to(np.asarray(s.minimum, np.float32), (n,)).ravel())
            highs.append(np.broadcast_to(np.asarray(s.maximum, np.float32), (n,)).ravel())
        elif isinstance(s, specs.Array):
            lows.append(np.full((n,), -np.inf, np.float32))
            highs.append(np.full((n,), np.inf, np.float32))
        else:
            raise ValueError(f"Unsupported dm_env spec: {type(s)}")
    low = np.concatenate(lows).astype(dtype)
    high = np.concatenate(highs).astype(dtype)
    return spaces.Box(low, high, low.shape, dtype)


def flatten_dmc_obs(obs: Dict[str, Any]) -> np.ndarray:
    """Flatten a dm_env observation OrderedDict into one 1-D float vector."""
    parts = [np.atleast_1d(np.asarray(v)).ravel() for v in obs.values()]
    return np.concatenate(parts, axis=0)


def rescale_action(action: np.ndarray, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Map an action in [-1, 1] onto the task's true bounds [low, high]."""
    action = np.asarray(action, np.float64)
    return (low + (action + 1.0) * 0.5 * (high - low)).astype(np.float32)


class DMCWrapper:
    """Gymnasium front-end over one dm_control suite task.

    Observation space (always a Dict):
      * ``rgb``   — camera render, uint8, CHW if `channels_first` — present
        when `from_pixels`;
      * ``state`` — flattened task observation vector — present when
        `from_vectors`.

    dm_env episode semantics: an episode that ends with discount 0 is a true
    termination; ending with discount 1 is a time-limit truncation
    (upstream sheeprl's dmc.py:228-229).
    """

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(
        self,
        domain_name: str,
        task_name: str,
        from_pixels: bool = False,
        from_vectors: bool = True,
        height: int = 84,
        width: int = 84,
        camera_id: int = 0,
        task_kwargs: Optional[Dict[str, Any]] = None,
        environment_kwargs: Optional[Dict[str, Any]] = None,
        channels_first: bool = True,
        visualize_reward: bool = False,
        seed: Optional[int] = None,
    ):
        if not (from_pixels or from_vectors):
            raise ValueError("At least one of 'from_pixels'/'from_vectors' must be True")
        task_kwargs = dict(task_kwargs or {})
        task_kwargs.pop("random", None)  # seeding goes through reset()

        self._env = suite.load(
            domain_name=domain_name,
            task_name=task_name,
            task_kwargs=task_kwargs,
            environment_kwargs=environment_kwargs,
            visualize_reward=visualize_reward,
        )
        self._from_pixels = from_pixels
        self._from_vectors = from_vectors
        self._height, self._width = height, width
        self._camera_id = camera_id
        self._channels_first = channels_first

        self._true_action_space = specs_to_box([self._env.action_spec()])
        self.action_space = spaces.Box(-1.0, 1.0, self._true_action_space.shape, np.float32)

        obs_spaces: Dict[str, spaces.Space] = {}
        if from_pixels:
            img_shape = (3, height, width) if channels_first else (height, width, 3)
            obs_spaces["rgb"] = spaces.Box(0, 255, img_shape, np.uint8)
        if from_vectors:
            obs_spaces["state"] = specs_to_box(self._env.observation_spec().values(), np.float64)
        self.observation_space = spaces.Dict(obs_spaces)
        self.state_space = specs_to_box(self._env.observation_spec().values(), np.float64)

        reward_box = specs_to_box([self._env.reward_spec()])
        self.reward_range = (float(reward_box.low[0]), float(reward_box.high[0]))
        self.render_mode = "rgb_array"
        self.current_state: Optional[np.ndarray] = None
        self._seed_spaces(seed)

    def _seed_spaces(self, seed: Optional[int]) -> None:
        self.action_space.seed(seed)
        self.observation_space.seed(seed)

    def _observe(self, time_step) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if self._from_pixels:
            frame = self.render()
            if self._channels_first:
                frame = np.transpose(frame, (2, 0, 1)).copy()
            out["rgb"] = frame
        if self._from_vectors:
            out["state"] = flatten_dmc_obs(time_step.observation)
        return out

    def step(self, action) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        scaled = rescale_action(action, self._true_action_space.low, self._true_action_space.high)
        ts = self._env.step(scaled)
        self.current_state = flatten_dmc_obs(ts.observation)
        terminated = bool(ts.last() and ts.discount == 0) and not ts.first()
        truncated = bool(ts.last() and ts.discount == 1)
        info = {"discount": ts.discount, "internal_state": self._env.physics.get_state().copy()}
        return self._observe(ts), float(ts.reward or 0.0), terminated, truncated, info

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        # dm_control tasks hold their RNG on the task object
        self._env.task._random = np.random.RandomState(seed)
        ts = self._env.reset()
        self.current_state = flatten_dmc_obs(ts.observation)
        return self._observe(ts), {}

    def render(self) -> np.ndarray:
        return self._env.physics.render(height=self._height, width=self._width, camera_id=self._camera_id)

    def close(self) -> None:
        self._env.close()
