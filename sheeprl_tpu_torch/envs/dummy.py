"""Deterministic synthetic environments (counterpart of
``sheeprl_tpu/envs/dummy.py``): a dict observation with a ``rgb`` pixel key
(CHW uint8) and a ``state`` vector key, across the three action-space
families."""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class _DummyEnv:
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
        sleep_ms: float = 0.0,
    ):
        self._sleep_s = max(0.0, float(sleep_ms)) / 1000.0
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, shape=image_size, dtype=np.uint8),
                "state": spaces.Box(-20, 20, shape=vector_shape, dtype=np.float32),
            }
        )
        self.reward_range = (-np.inf, np.inf)
        self._current_step = 0
        self._n_steps = n_steps

    def get_obs(self):
        return {
            "rgb": np.full(self.observation_space["rgb"].shape, self._current_step % 256, dtype=np.uint8),
            "state": np.full(self.observation_space["state"].shape, self._current_step % 20, dtype=np.float32),
        }

    def step(self, action):
        if self._sleep_s > 0.0:
            time.sleep(self._sleep_s)
        done = self._current_step == self._n_steps
        self._current_step += 1
        return self.get_obs(), 0.0, done, False, {}

    def reset(self, seed=None, options=None):
        self._current_step = 0
        return self.get_obs(), {}

    def render(self):
        return np.zeros((64, 64, 3), dtype=np.uint8)

    def close(self):
        pass


class ContinuousDummyEnv(_DummyEnv):
    def __init__(self, action_dim: int = 2, **kwargs):
        self.action_space = spaces.Box(-np.inf, np.inf, shape=(action_dim,))
        super().__init__(**kwargs)


class DiscreteDummyEnv(_DummyEnv):
    def __init__(self, action_dim: int = 2, n_steps: int = 4, **kwargs):
        self.action_space = spaces.Discrete(action_dim)
        super().__init__(n_steps=n_steps, **kwargs)


class MultiDiscreteDummyEnv(_DummyEnv):
    def __init__(self, action_dims: List[int] = (2, 2), **kwargs):
        self.action_space = spaces.MultiDiscrete(action_dims)
        super().__init__(**kwargs)
