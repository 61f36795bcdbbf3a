"""Environment factory (counterpart of ``sheeprl_tpu/envs/env.py::make_env``)
for the dummy envs.

The serving slice builds one env only to learn the observation and action
spaces of a checkpoint's run.  The other env backends (Atari, DMC, Crafter,
MineRL, MineDojo, DIAMBRA, Super Mario Bros) and the frame-stack,
actions-as-observation, reward-as-observation and mask-velocity wrappers
raise ``NotImplementedError`` until ROADMAP.md Queue 1 item "Envs" lands.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import ActionRepeat, Wrapper

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
        return env

    return thunk
