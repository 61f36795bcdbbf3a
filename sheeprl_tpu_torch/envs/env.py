"""Environment factory (counterpart of ``sheeprl_tpu/envs/env.py``) for the
dummy envs: ``make_env``, ``make_env_fns`` and a synchronous vector env.

Serving builds one env to learn a checkpoint's spaces; training steps a
:class:`SyncVectorEnv` of them.  The other env backends (Atari, DMC,
Crafter, MineRL, MineDojo, DIAMBRA, Super Mario Bros), the frame-stack,
actions-as-observation, reward-as-observation and mask-velocity wrappers and
the pipelined executors raise ``NotImplementedError`` until ROADMAP.md
Queue 1 item "Envs" lands.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import ActionRepeat, TimeLimit, Wrapper

_NOT_PORTED = "not ported yet: see ROADMAP.md Queue 1, item 'Envs'"


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


def make_env(
    cfg: Dict[str, Any],
    seed: int,
    rank: int,
    run_name: Optional[str] = None,
    prefix: str = "",
) -> Callable[[], Any]:
    """Build a thunk creating one wrapped dummy env."""
    del rank, run_name, prefix  # video capture and per-rank seeding come with the env backends

    def thunk():
        wrapper_cfg = dict(cfg.env.wrapper)
        target = _wrapper_target(wrapper_cfg)
        if target != "envs.env.get_dummy_env":
            raise NotImplementedError(f"env backend {wrapper_cfg.get('_target_')!r} is {_NOT_PORTED}")
        env = get_dummy_env(wrapper_cfg["id"], sleep_ms=float(wrapper_cfg.get("sleep_ms") or 0.0))

        if cfg.env.action_repeat > 1:
            env = ActionRepeat(env, cfg.env.action_repeat)
        unported = {
            "env.mask_velocities": bool(cfg.env.get("mask_velocities", False)),
            "env.frame_stack > 1": cfg.env.frame_stack > 1,
            "env.actions_as_observation.num_stack > 0": cfg.env.actions_as_observation.num_stack > 0,
            "env.reward_as_observation": bool(cfg.env.reward_as_observation),
        }
        for option, selected in unported.items():
            if selected:
                raise NotImplementedError(f"{option} is {_NOT_PORTED}")

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
        env.action_space.seed(seed)
        env.observation_space.seed(seed)
        if cfg.env.get("max_episode_steps") and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        return env

    return thunk


def make_env_fns(cfg, log_dir: Optional[str] = None, prefix: str = "train") -> List[Callable[[], Any]]:
    """One thunk per env of ``env.num_envs``, env ``i`` seeded ``seed + i``.
    (The JAX package also wraps each in ``RestartOnException``; the dummy
    envs never raise, and that wrapper is still to port.)"""
    return [make_env(cfg, cfg.seed + i, 0, log_dir, prefix) for i in range(cfg.env.num_envs)]


class SyncVectorEnv:
    """The envs stepped one after another in this process, with the
    same-step autoreset of the JAX package's vector envs: when an env ends
    its episode, the observation returned is the new episode's first and the
    last one rides in ``infos["final_obs"]``.  ``infos["episodes"]`` lists
    the (return, length) of every episode that ended in the step."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._returns = np.zeros(self.num_envs, np.float64)
        self._lengths = np.zeros(self.num_envs, np.int64)

    @property
    def batched_action_shape(self) -> Tuple[int, ...]:
        return (self.num_envs,) + tuple(self.single_action_space.shape)

    def sample_actions(self, rng: np.random.Generator) -> np.ndarray:
        """Uniform random actions for every env (the prefill's)."""
        space, n = self.single_action_space, self.num_envs
        if isinstance(space, spaces.Discrete):
            return rng.integers(0, space.n, size=(n,))
        if isinstance(space, spaces.MultiDiscrete):
            return rng.integers(0, space.nvec, size=(n,) + space.nvec.shape)
        if isinstance(space, spaces.Box):
            # uniform where both bounds are finite, a standard normal elsewhere
            shape = (n,) + space.shape
            bounded = np.isfinite(space.low) & np.isfinite(space.high)
            low, high = np.where(bounded, space.low, 0.0), np.where(bounded, space.high, 0.0)
            uniform = low + (high - low) * rng.random(shape)
            return np.where(bounded, uniform, rng.standard_normal(shape)).astype(space.dtype)
        raise NotImplementedError(f"sampling {space!r} is not ported")

    def _stack(self, obs: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([o[k] for o in obs]) for k in obs[0]}

    def reset(self, seed: Optional[int] = None):
        obs = [env.reset(seed=None if seed is None else seed + i)[0] for i, env in enumerate(self.envs)]
        self._returns[:] = 0
        self._lengths[:] = 0
        return self._stack(obs), {}

    def step(self, actions: np.ndarray):
        obs, rewards, terminated, truncated = [], [], [], []
        final_obs: List[Optional[Dict[str, np.ndarray]]] = [None] * self.num_envs
        episodes = []
        for i, env in enumerate(self.envs):
            o, r, term, trunc, _ = env.step(actions[i])
            self._returns[i] += r
            self._lengths[i] += 1
            if term or trunc:
                final_obs[i] = o
                episodes.append((self._returns[i], self._lengths[i]))
                self._returns[i], self._lengths[i] = 0, 0
                o = env.reset()[0]
            obs.append(o)
            rewards.append(r)
            terminated.append(term)
            truncated.append(trunc)
        infos = {"final_obs": final_obs, "episodes": episodes}
        return (self._stack(obs), np.asarray(rewards, np.float32), np.asarray(terminated, bool),
                np.asarray(truncated, bool), infos)

    def close(self) -> None:
        for env in self.envs:
            env.close()


def vectorized_env(env_fns: Sequence[Callable[[], Any]]) -> SyncVectorEnv:
    """The synchronous vector env; the JAX package's async and shared-memory
    executors are still to port (ROADMAP.md Queue 1)."""
    return SyncVectorEnv(env_fns)
