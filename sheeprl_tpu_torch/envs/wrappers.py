"""Env wrappers (counterpart of ``sheeprl_tpu/envs/wrappers.py``): the base
wrapper, the ``ActionRepeat`` that ``make_env`` applies to the dummy envs
and the episode ``TimeLimit`` (gymnasium's, which the JAX package uses)."""

from __future__ import annotations


class Wrapper:
    """Forwards everything to the wrapped env; subclasses override what they
    change."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def step(self, action):
        return self.env.step(action)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

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
