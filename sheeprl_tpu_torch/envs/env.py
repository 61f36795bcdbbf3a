"""Environment factory (counterpart of ``sheeprl_tpu/envs/env.py``):
``make_env`` and ``make_env_fns``, the dict-observation normalization and
the pixel pipeline, the executor choice and the synchronous vector env.

Two env targets are ported: the dummy envs (``env=dummy``) and
``gymnasium.make`` (``env=gym``), which imports gymnasium inside the thunk:
the port's modules never need it, and a machine without it fails only when
such an env is built.  A gymnasium env is adapted to the port's spaces
(``envs/spaces.py``) as it is built.  The other backends (Atari, DMC,
Crafter, MineRL, MineDojo, DIAMBRA, Super Mario Bros) and video capture
raise ``NotImplementedError`` (ROADMAP.md Queue 1).

A thunk is an :class:`EnvThunk`, a module-level callable holding the
config, seed, rank and index, so that it crosses to the spawned env
workers by the standard pickle.
"""

from __future__ import annotations

import functools
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.executor import VectorEnv
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    ActionsAsObservationWrapper,
    FrameStack,
    MaskVelocityWrapper,
    RecordEpisodeStatistics,
    RestartOnException,
    RewardAsObservationWrapper,
    TimeLimit,
    Wrapper,
)

_NOT_PORTED = "not ported yet: see ROADMAP.md Queue 1"


def _port_space(space: Any) -> spaces.Space:
    """A gymnasium space as the port's."""
    name = type(space).__name__
    if name == "Box":
        return spaces.Box(space.low, space.high, space.shape, space.dtype)
    if name == "Discrete":
        if int(space.start) != 0:
            raise NotImplementedError(f"a Discrete space starting at {space.start} is {_NOT_PORTED}")
        return spaces.Discrete(int(space.n))
    if name == "MultiDiscrete":
        return spaces.MultiDiscrete(np.asarray(space.nvec).tolist())
    if name == "Dict":
        return spaces.Dict({k: _port_space(s) for k, s in space.spaces.items()})
    raise NotImplementedError(f"the gymnasium space {space!r} is {_NOT_PORTED}")


class _GymnasiumEnv:
    """A gymnasium env behind the port's spaces; ``env_id`` is its
    registered id (what velocity masking looks up)."""

    def __init__(self, env: Any):
        self.env = env
        spec = getattr(env.unwrapped, "spec", None)
        self.env_id = spec.id if spec is not None else None
        self.observation_space = _port_space(env.observation_space)
        self.action_space = _port_space(env.action_space)
        self.reward_range = getattr(env, "reward_range", None)

    @property
    def unwrapped(self):
        return self

    def step(self, action):
        return self.env.step(action)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def render(self):
        return self.env.render()

    def close(self):
        self.env.close()


class _DictObs(Wrapper):
    """A single Box observation under a named key."""

    def __init__(self, env, key: str):
        super().__init__(env)
        self._key = key
        self.observation_space = spaces.Dict({key: env.observation_space})

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return {self._key: obs}, reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return {self._key: obs}, info


class _RenderPixels(Wrapper):
    """A pixel key from ``env.render()`` for a vector-observation env whose
    config asks for a cnn encoder (the vector, if kept, under ``state_key``)."""

    def __init__(self, env, pixel_key: str, state_key: Optional[str] = None):
        super().__init__(env)
        self._pixel_key = pixel_key
        self._state_key = state_key
        env.reset()  # gymnasium forbids render() before the first reset
        frame = env.render()
        if frame is None:
            raise RuntimeError(f"Cannot build pixel observations for '{env}' because render() returned None; "
                               "construct the env with render_mode='rgb_array'")
        frame = np.asarray(frame)
        obs_spaces = {pixel_key: spaces.Box(0, 255, frame.shape, np.uint8)}
        if state_key is not None:
            obs_spaces[state_key] = env.observation_space
        self.observation_space = spaces.Dict(obs_spaces)

    def _obs(self, observation):
        out = {self._pixel_key: np.asarray(self.env.render(), dtype=np.uint8)}
        if self._state_key is not None:
            out[self._state_key] = observation
        return out

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._obs(obs), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._obs(obs), info


class _PixelPipeline(Wrapper):
    """cv2 resize + optional grayscale + CHW uint8 for each cnn key."""

    def __init__(self, env, cnn_keys, screen_size: int, grayscale: bool):
        super().__init__(env)
        self._cnn_keys = cnn_keys
        self._screen_size = screen_size
        self._grayscale = grayscale
        self.observation_space = spaces.Dict(dict(env.observation_space.spaces))
        for k in cnn_keys:
            self.observation_space[k] = spaces.Box(
                0, 255, (1 if grayscale else 3, screen_size, screen_size), np.uint8
            )

    def observation(self, obs):
        import cv2

        for k in self._cnn_keys:
            current = np.asarray(obs[k])
            shape = current.shape
            is_3d = len(shape) == 3
            is_grayscale = not is_3d or shape[0] == 1 or shape[-1] == 1
            channel_first = not is_3d or shape[0] in (1, 3)
            if not is_3d:
                current = np.expand_dims(current, axis=0)
            if channel_first:
                current = np.transpose(current, (1, 2, 0))
            if current.shape[:-1] != (self._screen_size, self._screen_size):
                current = cv2.resize(
                    current, (self._screen_size, self._screen_size), interpolation=cv2.INTER_AREA
                )
            if self._grayscale and not is_grayscale:
                current = cv2.cvtColor(current, cv2.COLOR_RGB2GRAY)
            if current.ndim == 2:
                current = np.expand_dims(current, axis=-1)
                if not self._grayscale:
                    current = np.repeat(current, 3, axis=-1)
            obs[k] = np.ascontiguousarray(current.transpose(2, 0, 1), dtype=np.uint8)
        return obs

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self.observation(obs), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info


def get_dummy_env(id: str, sleep_ms: float = 0.0):
    """Dummy env selector by id."""
    if "continuous" in id:
        from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

        return ContinuousDummyEnv(sleep_ms=sleep_ms)
    elif "multidiscrete" in id:
        from sheeprl_tpu_torch.envs.dummy import MultiDiscreteDummyEnv

        return MultiDiscreteDummyEnv(sleep_ms=sleep_ms)
    elif "discrete" in id:
        from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv

        return DiscreteDummyEnv(sleep_ms=sleep_ms)
    raise ValueError(f"Unrecognized dummy environment: {id}")


def _wrapper_target(wrapper_cfg: Dict[str, Any]) -> str:
    """The env factory named by ``env.wrapper._target_``, without its package
    prefix: a config archived by the JAX package names ``sheeprl_tpu.…`` and
    one composed by the port ``sheeprl_tpu_torch.…``."""
    target = str(wrapper_cfg.get("_target_", ""))
    for prefix in ("sheeprl_tpu_torch.", "sheeprl_tpu."):
        if target.startswith(prefix):
            return target[len(prefix):]
    return target


def _instantiate_env(wrapper_cfg: Dict[str, Any]):
    target = _wrapper_target(wrapper_cfg)
    if target == "envs.env.get_dummy_env":
        return get_dummy_env(wrapper_cfg["id"], sleep_ms=float(wrapper_cfg.get("sleep_ms") or 0.0))
    if target == "gymnasium.make":
        import gymnasium

        kwargs = {k: v for k, v in wrapper_cfg.items() if k != "_target_"}
        return _GymnasiumEnv(gymnasium.make(**kwargs))
    raise NotImplementedError(f"env backend {wrapper_cfg.get('_target_')!r} is {_NOT_PORTED}")


class EnvThunk:
    """Builds one fully wrapped env of ``cfg`` (the JAX package's
    ``make_env`` thunk), picklable by the standard pickle."""

    def __init__(self, cfg: Dict[str, Any], seed: int, rank: int, run_name: Optional[str] = None, prefix: str = "",
                 vector_env_idx: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.rank = rank
        self.run_name = run_name
        self.prefix = prefix
        self.vector_env_idx = vector_env_idx

    def __call__(self):
        cfg = self.cfg
        env = _instantiate_env(dict(cfg.env.wrapper))
        if cfg.env.action_repeat > 1:
            env = ActionRepeat(env, cfg.env.action_repeat)
        if cfg.env.get("mask_velocities", False):
            env = MaskVelocityWrapper(env)

        cnn_encoder_keys = cfg.algo.cnn_keys.encoder
        mlp_encoder_keys = cfg.algo.mlp_keys.encoder
        if not (
            isinstance(mlp_encoder_keys, list)
            and isinstance(cnn_encoder_keys, list)
            and len(cnn_encoder_keys + mlp_encoder_keys) > 0
        ):
            raise ValueError(
                "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be lists of strings with at "
                f"least one total key, got: cnn={cnn_encoder_keys} mlp={mlp_encoder_keys}"
            )

        # every observation space becomes a Dict
        if isinstance(env.observation_space, spaces.Box) and len(env.observation_space.shape) < 2:
            if len(cnn_encoder_keys) > 0:
                if len(cnn_encoder_keys) > 1:
                    warnings.warn(f"Only the first cnn key is kept for {cfg.env.id}: {cnn_encoder_keys[0]}")
                state_key = mlp_encoder_keys[0] if len(mlp_encoder_keys) > 0 else None
                env = _RenderPixels(env, pixel_key=cnn_encoder_keys[0], state_key=state_key)
            else:
                if len(mlp_encoder_keys) > 1:
                    warnings.warn(f"Only the first mlp key is kept for {cfg.env.id}: {mlp_encoder_keys[0]}")
                env = _DictObs(env, mlp_encoder_keys[0])
        elif isinstance(env.observation_space, spaces.Box) and 2 <= len(env.observation_space.shape) <= 3:
            if len(cnn_encoder_keys) == 0:
                raise ValueError(
                    "You have selected a pixel observation but no cnn key has been specified. "
                    "Set `algo.cnn_keys.encoder=[your_cnn_key]`"
                )
            if len(cnn_encoder_keys) > 1:
                warnings.warn(f"Only the first cnn key is kept for {cfg.env.id}: {cnn_encoder_keys[0]}")
            env = _DictObs(env, cnn_encoder_keys[0])

        requested = set(mlp_encoder_keys + cnn_encoder_keys)
        if not requested.intersection(env.observation_space.keys()):
            raise ValueError(
                f"The user-specified keys {sorted(requested)} are not a subset of the environment "
                f"observation keys {sorted(env.observation_space.keys())}. Check your config."
            )
        env_cnn_keys = {k for k in env.observation_space.keys() if len(env.observation_space[k].shape) in (2, 3)}
        cnn_keys = sorted(env_cnn_keys.intersection(cnn_encoder_keys))
        if cnn_keys:
            env = _PixelPipeline(env, cnn_keys, cfg.env.screen_size, cfg.env.grayscale)
            if cfg.env.frame_stack > 1:
                if cfg.env.frame_stack_dilation <= 0:
                    raise ValueError(
                        f"The frame stack dilation argument must be greater than zero, "
                        f"got: {cfg.env.frame_stack_dilation}"
                    )
                env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)

        if cfg.env.actions_as_observation.num_stack > 0:
            env = ActionsAsObservationWrapper(env, **cfg.env.actions_as_observation)
        if cfg.env.reward_as_observation:
            env = RewardAsObservationWrapper(env)

        env.action_space.seed(self.seed)
        env.observation_space.seed(self.seed)
        if cfg.env.get("max_episode_steps") and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        return RecordEpisodeStatistics(env)


def make_env(
    cfg: Dict[str, Any],
    seed: int,
    rank: int,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> EnvThunk:
    """The thunk of one wrapped env.  A run's envs (``run_name`` given) with
    ``env.capture_video`` raise: video capture is not ported."""
    if cfg.env.get("capture_video", False) and run_name is not None:
        raise NotImplementedError(f"env.capture_video=True (video capture) is {_NOT_PORTED}; "
                                  "pass env.capture_video=False")
    return EnvThunk(cfg, seed, rank, run_name, prefix, vector_env_idx)


def make_env_fns(cfg, log_dir: Optional[str] = None, prefix: str = "train",
                 restartable: bool = True) -> List[Callable[[], Any]]:
    """One thunk per env of ``env.num_envs``, env ``i`` seeded ``seed + i``,
    each wrapped in :class:`~sheeprl_tpu_torch.envs.wrappers.RestartOnException`
    unless ``restartable`` is False: a restarted env reports
    ``info["restart_on_exception"]``."""
    fns = []
    for i in range(cfg.env.num_envs):
        thunk = make_env(cfg, cfg.seed + i, 0, log_dir, prefix, vector_env_idx=i)
        fns.append(functools.partial(RestartOnException, thunk) if restartable else thunk)
    return fns


def resolve_executor(cfg) -> str:
    """``env.executor`` (``sync`` | ``async`` | ``shared_memory``), or with
    it unset / ``auto`` what ``env.sync_env`` selects."""
    executor = cfg.env.get("executor", None)
    if executor in (None, "", "auto"):
        return "sync" if cfg.env.sync_env else "async"
    executor = str(executor)
    from sheeprl_tpu_torch.envs.pipeline import EXECUTORS

    if executor not in EXECUTORS:
        raise ValueError(f"env.executor must be one of {EXECUTORS} (or null/auto), got: {executor}")
    return executor


def pipelined_vector_env(cfg, env_fns):
    """The configured executor, each one split-phase
    (:class:`~sheeprl_tpu_torch.envs.pipeline.PipelinedVectorEnv`).  An
    offline run builds no envs: reaching here with ``algo.offline.enabled``
    raises."""
    if ((cfg.get("algo") or {}).get("offline") or {}).get("enabled"):
        raise RuntimeError(
            "algo.offline.enabled=true is an env-free training mode: environments must not "
            "be constructed (the offline entrypoint drives the train step from the dataset loader)"
        )
    executor = resolve_executor(cfg)
    if executor == "shared_memory":
        from sheeprl_tpu_torch.envs.executor import SharedMemoryVectorEnv

        return SharedMemoryVectorEnv(env_fns, envs_per_worker=cfg.env.get("envs_per_worker", None))
    return vectorized_env(env_fns, sync=executor == "sync")


class SyncVectorEnv(VectorEnv):
    """The envs stepped one after another in this process, with gymnasium's
    ``SyncVectorEnv`` results under ``SAME_STEP`` autoreset (float64
    rewards, the infos layout of ``executor.py``); ``step_async`` runs the
    serial step on one background thread."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="env-step")  # its thread starts at the first step
        self._future: Optional[Future] = None

    def _reset(self, seeds, options):
        obs, infos = [], {}
        for i, (env, s) in enumerate(zip(self.envs, seeds)):
            o, info = env.reset(seed=s, options=options)
            obs.append(o)
            infos = self._add_info(infos, info, i)
        return self._stack(obs), infos

    def _serial_step(self, actions: np.ndarray):
        obs, infos = [], {}
        rewards = np.zeros((self.num_envs,), dtype=np.float64)
        terminated = np.zeros((self.num_envs,), dtype=np.bool_)
        truncated = np.zeros((self.num_envs,), dtype=np.bool_)
        for i, env in enumerate(self.envs):
            o, rewards[i], terminated[i], truncated[i], info = env.step(actions[i])
            if terminated[i] or truncated[i]:
                infos = self._add_info(infos, {"final_obs": o, "final_info": info}, i)
                o, info = env.reset()
            obs.append(o)
            infos = self._add_info(infos, info, i)
        return self._stack(obs), rewards, terminated, truncated, infos

    def _step_async(self, actions: np.ndarray) -> None:
        self._future = self._pool.submit(self._serial_step, actions)

    def _step_wait(self):
        future, self._future = self._future, None
        return future.result()

    def _close(self) -> None:
        self._pool.shutdown(wait=True)
        for env in self.envs:
            env.close()


def vectorized_env(env_fns: Sequence[Callable[[], Any]], sync: bool = True):
    """``SyncVectorEnv`` or, with ``sync=False``, the ``AsyncVectorEnv`` of
    one spawned process per env."""
    if sync:
        return SyncVectorEnv(env_fns)
    from sheeprl_tpu_torch.envs.executor import AsyncVectorEnv

    return AsyncVectorEnv(env_fns)
