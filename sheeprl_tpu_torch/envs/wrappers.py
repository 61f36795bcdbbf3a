"""Env wrappers (counterpart of ``sheeprl_tpu/envs/wrappers.py``), over the
port's own spaces (``envs/spaces.py``) so that no env needs gymnasium: the
base wrapper, ``ActionRepeat``, the frame-stack ring with dilation, actions
and reward as observations, velocity masking, ``RestartOnException``, and
the wrappers of gymnasium the JAX package applies, the episode
``TimeLimit``, ``RecordEpisodeStatistics`` and ``RecordVideo`` (with
``GrayscaleRenderWrapper``), with gymnasium's semantics."""

from __future__ import annotations

import copy
import os
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class Wrapper:
    """Forwards everything to the wrapped env; subclasses override what they
    change."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    @property
    def render_mode(self):
        return getattr(self.env, "render_mode", None)

    @property
    def metadata(self):
        return getattr(self.env, "metadata", {})

    def step(self, action):
        return self.env.step(action)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def render(self):
        return self.env.render()

    def close(self):
        self.env.close()


class ActionRepeat(Wrapper):
    """Repeat each action ``amount`` times, summing rewards."""

    def __init__(self, env, amount: int = 1):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = amount

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action):
        done = truncated = False
        total_reward, current_step = 0.0, 0
        obs, info = None, {}
        while current_step < self._amount and not (done or truncated):
            obs, reward, done, truncated, info = self.env.step(action)
            total_reward += reward
            current_step += 1
        return obs, total_reward, done, truncated, info


class TimeLimit(Wrapper):
    """Truncate an episode after ``max_episode_steps`` steps."""

    def __init__(self, env, max_episode_steps: int):
        super().__init__(env)
        self._max_episode_steps = int(max_episode_steps)
        self._elapsed = 0

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self._max_episode_steps:
            truncated = True
        return obs, reward, done, truncated, info

    def reset(self, seed=None, options=None):
        self._elapsed = 0
        return self.env.reset(seed=seed, options=options)


class RecordEpisodeStatistics(Wrapper):
    """gymnasium's ``RecordEpisodeStatistics``: at the end of an episode
    ``info["episode"]`` holds its return ``r``, length ``l`` and wall-clock
    seconds ``t`` (rounded to the microsecond), the types gymnasium gives
    them, so the vector envs batch them alike."""

    def __init__(self, env):
        super().__init__(env)
        self.episode_start_time: float = -1
        self.episode_returns: float = 0.0
        self.episode_lengths: int = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.episode_returns += reward
        self.episode_lengths += 1
        if terminated or truncated:
            if "episode" in info:
                raise KeyError("the wrapped env already reports info['episode']")
            info["episode"] = {
                "r": self.episode_returns,
                "l": self.episode_lengths,
                "t": round(time.perf_counter() - self.episode_start_time, 6),
            }
            self.episode_start_time = time.perf_counter()
        return obs, reward, terminated, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        self.episode_start_time = time.perf_counter()
        self.episode_returns = 0.0
        self.episode_lengths = 0
        return obs, info


class MaskVelocityWrapper(Wrapper):
    """Zero the velocity terms of a classic-control observation, making the
    MDP partially observable.  ``env_id`` defaults to the id the gymnasium
    adapter of ``env.py`` records."""

    velocity_indices = {
        "CartPole-v0": np.array([1, 3]),
        "CartPole-v1": np.array([1, 3]),
        "MountainCar-v0": np.array([1]),
        "MountainCarContinuous-v0": np.array([1]),
        "Pendulum-v1": np.array([2]),
        "LunarLander-v2": np.array([2, 3, 5]),
        "LunarLanderContinuous-v2": np.array([2, 3, 5]),
        "LunarLander-v3": np.array([2, 3, 5]),
    }

    def __init__(self, env, env_id: Optional[str] = None):
        super().__init__(env)
        env_id = env_id or getattr(self.unwrapped, "env_id", None)
        space = env.observation_space
        self.mask = np.ones(space.shape, dtype=space.dtype)
        if env_id not in self.velocity_indices:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}")
        self.mask[self.velocity_indices[env_id]] = 0.0

    def observation(self, observation: np.ndarray) -> np.ndarray:
        return observation * self.mask

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self.observation(obs), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info


class RestartOnException(Wrapper):
    """Recreate a crashed env and carry on: a step that raises returns the
    new env's first observation, reward 0, not done, with
    ``info["restart_on_exception"] = True``; more than ``maxfails`` crashes
    within ``window`` seconds raise."""

    def __init__(
        self,
        env_fn: Callable[[], Any],
        exceptions: Union[type, Tuple[type, ...]] = (Exception,),
        window: float = 300,
        maxfails: int = 2,
        wait: float = 20,
    ):
        if not isinstance(exceptions, (tuple, list)):
            exceptions = (exceptions,)
        self._env_fn = env_fn
        self._exceptions = tuple(exceptions)
        self._window = window
        self._maxfails = maxfails
        self._wait = wait
        self._last = time.time()
        self._fails = 0
        super().__init__(self._env_fn())

    def _register_failure(self, origin: str, err: Exception) -> None:
        if time.time() > self._last + self._window:
            self._last = time.time()
            self._fails = 1
        else:
            self._fails += 1
        if self._fails > self._maxfails:
            raise RuntimeError(f"The env crashed too many times: {self._fails}") from err
        warnings.warn(f"{origin} - Restarting env after crash with {type(err).__name__}: {err}")
        time.sleep(self._wait)

    def step(self, action):
        try:
            return self.env.step(action)
        except self._exceptions as e:
            self._register_failure("STEP", e)
            self.env = self._env_fn()
            new_obs, info = self.env.reset()
            info.update({"restart_on_exception": True})
            return new_obs, 0.0, False, False, info

    def reset(self, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        try:
            return self.env.reset(seed=seed, options=options)
        except self._exceptions as e:
            self._register_failure("RESET", e)
            self.env = self._env_fn()
            new_obs, info = self.env.reset(seed=seed, options=options)
            info.update({"restart_on_exception": True})
            return new_obs, info


class FrameStack(Wrapper):
    """A rolling window over each pixel key: the observation becomes
    ``[num_stack, ...]``, every ``dilation``-th of the newest
    ``num_stack * dilation`` frames, newest last.  Each key owns a ring of
    ``num_stack * dilation`` frames: a step copies the newest frame in and
    gathers the window out."""

    def __init__(self, env, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1) -> None:
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"num_stack must be a positive integer, got {num_stack}")
        if dilation <= 0:
            raise ValueError(f"dilation must be a positive integer, got {dilation}")
        if not isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError(f"FrameStack needs a Dict observation space, got {type(env.observation_space)}")
        self._num_stack = num_stack
        self._dilation = dilation
        self._window = num_stack * dilation
        wanted = set(cnn_keys or ())
        tracked = [k for k, space in env.observation_space.spaces.items() if k in wanted and len(space.shape) == 3]
        if not tracked:
            raise RuntimeError(f"None of the cnn keys {sorted(wanted)} name a 3-D observation to stack")
        self.observation_space = copy.deepcopy(env.observation_space)
        self._ring: Dict[str, np.ndarray] = {}
        for k in tracked:
            space = env.observation_space[k]
            self.observation_space[k] = spaces.Box(
                np.broadcast_to(space.low, (num_stack, *space.shape)).copy(),
                np.broadcast_to(space.high, (num_stack, *space.shape)).copy(),
                (num_stack, *space.shape),
                space.dtype,
            )
            self._ring[k] = np.zeros((self._window, *space.shape), dtype=space.dtype)
        self._frames_seen = 0

    def _stacked(self, key: str) -> np.ndarray:
        # the frame of age a (newest 0) lives in slot (frames_seen - 1 - a) % window
        newest = self._frames_seen - 1
        slots = (newest - self._dilation * np.arange(self._num_stack - 1, -1, -1)) % self._window
        return self._ring[key][slots]

    def step(self, action):
        obs, reward, done, truncated, infos = self.env.step(action)
        slot = self._frames_seen % self._window
        self._frames_seen += 1
        # a DIAMBRA round/stage/game boundary that does not end the episode
        # restarts play from a fresh scene: the window fills with its frame
        reflood = (
            infos.get("env_domain") == "DIAMBRA"
            and {"round_done", "stage_done", "game_done"} <= infos.keys()
            and (infos["round_done"] or infos["stage_done"] or infos["game_done"])
            and not (done or truncated)
        )
        for k, ring in self._ring.items():
            if reflood:
                ring[:] = obs[k][None]
            else:
                ring[slot] = obs[k]
            obs[k] = self._stacked(k)
        return obs, reward, done, truncated, infos

    def reset(self, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, infos = self.env.reset(seed=seed, options=options)
        self._frames_seen = self._window
        for k, ring in self._ring.items():
            ring[:] = obs[k][None]
            obs[k] = self._stacked(k)
        return obs, infos


class RewardAsObservationWrapper(Wrapper):
    """The last reward as a ``reward`` observation key (0 after a reset)."""

    def __init__(self, env) -> None:
        super().__init__(env)
        reward_range = getattr(self.env, "reward_range", None) or (-np.inf, np.inf)
        reward_space = spaces.Box(*reward_range, (1,), np.float32)
        if isinstance(self.env.observation_space, spaces.Dict):
            self.observation_space = spaces.Dict({"reward": reward_space, **self.env.observation_space.spaces})
        else:
            self.observation_space = spaces.Dict({"obs": self.env.observation_space, "reward": reward_space})

    def _convert_obs(self, obs: Any, reward: Union[float, np.ndarray]) -> Dict[str, Any]:
        reward_obs = np.asarray(reward, dtype=np.float32).reshape(-1)
        if isinstance(obs, dict):
            obs["reward"] = reward_obs
        else:
            obs = {"obs": obs, "reward": reward_obs}
        return obs

    def step(self, action):
        obs, reward, done, truncated, infos = self.env.step(action)
        return self._convert_obs(obs, copy.deepcopy(reward)), reward, done, truncated, infos

    def reset(self, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, infos = self.env.reset(seed=seed, options=options)
        return self._convert_obs(obs, 0), infos


class ActionsAsObservationWrapper(Wrapper):
    """The last actions (one-hot for discrete spaces), every ``dilation``-th
    of the newest ``num_stack * dilation``, as an ``action_stack`` key; a
    reset fills the window with ``noop``."""

    def __init__(self, env, num_stack: int, noop: float | int | List[int], dilation: int = 1):
        super().__init__(env)
        if num_stack < 1:
            raise ValueError(f"The number of stacked actions must be greater or equal than 1, got: {num_stack}")
        if dilation < 1:
            raise ValueError(f"The actions stack dilation argument must be greater than zero, got: {dilation}")
        if not isinstance(noop, (int, float, list)):
            raise ValueError(f"The noop action must be an integer or float or list, got: {noop} ({type(noop)})")
        self._num_stack = num_stack
        self._dilation = dilation
        self._actions: deque = deque(maxlen=num_stack * dilation)
        space = self.env.action_space
        self._is_continuous = isinstance(space, spaces.Box)
        self._is_multidiscrete = isinstance(space, spaces.MultiDiscrete)
        self.observation_space = copy.deepcopy(self.env.observation_space)
        if self._is_continuous:
            self._action_shape = space.shape[0]
            low = np.resize(space.low, self._action_shape * num_stack)
            high = np.resize(space.high, self._action_shape * num_stack)
        elif self._is_multidiscrete:
            low, high = 0, 1
            self._action_shape = int(sum(space.nvec))
        else:
            low, high = 0, 1
            self._action_shape = int(space.n)
        self.observation_space["action_stack"] = spaces.Box(low, high, (self._action_shape * num_stack,), np.float32)
        if self._is_continuous:
            if isinstance(noop, list):
                raise ValueError(f"The noop actions must be a float for continuous action spaces, got: {noop}")
            self.noop = np.full((self._action_shape,), noop, dtype=np.float32)
        elif self._is_multidiscrete:
            if not isinstance(noop, list):
                raise ValueError(f"The noop actions must be a list for multi-discrete action spaces, got: {noop}")
            if len(space.nvec) != len(noop):
                raise RuntimeError(
                    "The number of noop actions must equal the number of actions of the environment. "
                    f"Got {space.nvec} and noop={noop}"
                )
            noops = []
            for noop_i, n in zip(noop, space.nvec):
                oh = np.zeros((int(n),), dtype=np.float32)
                oh[noop_i] = 1.0
                noops.append(oh)
            self.noop = np.concatenate(noops, axis=-1)
        else:
            if isinstance(noop, (list, float)):
                raise ValueError(f"The noop actions must be an integer for discrete action spaces, got: {noop}")
            self.noop = np.zeros((self._action_shape,), dtype=np.float32)
            self.noop[noop] = 1.0

    def _one_hot(self, action) -> np.ndarray:
        if self._is_continuous:
            return np.asarray(action, dtype=np.float32).reshape(-1)
        if self._is_multidiscrete:
            parts = []
            for act, n in zip(action, self.env.action_space.nvec):
                oh = np.zeros((int(n),), dtype=np.float32)
                oh[int(act)] = 1.0
                parts.append(oh)
            return np.concatenate(parts, axis=-1)
        oh = np.zeros((self._action_shape,), dtype=np.float32)
        oh[int(np.asarray(action).item())] = 1.0
        return oh

    def _get_actions_stack(self) -> np.ndarray:
        actions_stack = list(self._actions)[self._dilation - 1 :: self._dilation]
        return np.concatenate(actions_stack, axis=-1).astype(np.float32)

    def step(self, action):
        self._actions.append(self._one_hot(action))
        obs, reward, done, truncated, info = self.env.step(action)
        obs["action_stack"] = self._get_actions_stack()
        return obs, reward, done, truncated, info

    def reset(self, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        self._actions.clear()
        for _ in range(self._num_stack * self._dilation):
            self._actions.append(self.noop)
        obs["action_stack"] = self._get_actions_stack()
        return obs, info


class GrayscaleRenderWrapper(Wrapper):
    """Renders grayscale frames as 3-channel so video encoders accept them."""

    def render(self):
        frame = self.env.render()
        if isinstance(frame, np.ndarray):
            if frame.ndim == 2:
                frame = frame[..., np.newaxis]
            if frame.ndim == 3 and frame.shape[-1] == 1:
                frame = frame.repeat(3, axis=-1)
        return frame


def capped_cubic_video_schedule(episode_id: int) -> bool:
    """gymnasium's default trigger: episodes 0, 1, 8, 27, ... below 1000,
    then every thousandth."""
    if episode_id < 1000:
        return int(round(episode_id ** (1.0 / 3))) ** 3 == episode_id
    return episode_id % 1000 == 0


class RecordVideo(Wrapper):
    """gymnasium's ``RecordVideo`` over the port's envs: the episodes that
    ``episode_trigger`` (by default :func:`capped_cubic_video_schedule`)
    picks are rendered frame by frame and written with moviepy to
    ``<video_folder>/<name_prefix>-episode-<id>.mp4`` at the next reset (or
    at ``close``).  As
    gymnasium's, it refuses an env that renders no image and needs moviepy
    when it is built."""

    def __init__(self, env, video_folder: str, episode_trigger: Optional[Callable[[int], bool]] = None,
                 name_prefix: str = "rl-video", fps: Optional[int] = None):
        super().__init__(env)
        if self.render_mode in (None, "human", "ansi"):
            raise ValueError(
                f"Render mode is {self.render_mode}, which is incompatible with RecordVideo.",
                "Initialize your environment with a render_mode that returns an image, such as rgb_array.",
            )
        self.episode_trigger = episode_trigger or capped_cubic_video_schedule
        self.video_folder = os.path.abspath(video_folder)
        os.makedirs(self.video_folder, exist_ok=True)
        self.fps = fps if fps is not None else self.metadata.get("render_fps", 30)
        self.name_prefix = name_prefix
        self.episode_id = -1
        self.frames: List[Any] = []
        self.video_name: Optional[str] = None
        try:
            import moviepy  # noqa: F401
        except ImportError as err:
            raise ImportError('moviepy is not installed, run `pip install "gymnasium[other]"`') from err

    def _capture(self) -> None:
        frame = self.env.render()
        if isinstance(frame, list):
            frame = frame[-1]
        if isinstance(frame, np.ndarray):
            self.frames.append(frame)

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        self.episode_id += 1
        if self.video_name is not None:
            self._write()
        if self.episode_trigger(self.episode_id):
            self.video_name = f"{self.name_prefix}-episode-{self.episode_id}"
            self._capture()
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        if self.video_name is not None:
            self._capture()
        return obs, reward, terminated, truncated, info

    def _write(self) -> None:
        from moviepy.video.io.ImageSequenceClip import ImageSequenceClip

        if self.frames:
            path = os.path.join(self.video_folder, f"{self.video_name}.mp4")
            ImageSequenceClip(self.frames, fps=self.fps).write_videofile(path, logger=None)
        self.frames, self.video_name = [], None

    def close(self):
        if self.video_name is not None:
            self._write()
        super().close()
