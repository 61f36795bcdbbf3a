"""The observation and action spaces the port's envs describe themselves with.

A small stand-in for the four ``gymnasium.spaces`` classes the serving slice
reads (``Box``, ``Discrete``, ``MultiDiscrete``, ``Dict``), with the same
attribute names, so the port does not depend on gymnasium being installed.
"""

from __future__ import annotations

from typing import Dict as TDict, Iterable, Optional, Sequence, Tuple

import numpy as np


class Space:
    shape: Tuple[int, ...] = ()
    dtype: np.dtype = np.dtype(np.float32)

    def seed(self, seed: Optional[int] = None) -> None:
        del seed  # the port's spaces are never sampled


class Box(Space):
    def __init__(self, low, high, shape: Sequence[int], dtype=np.float32):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape)

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    def __init__(self, nvec: Iterable[int]):
        self.nvec = np.asarray(list(nvec), dtype=np.int64)
        self.shape = self.nvec.shape
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class Dict(Space):
    def __init__(self, spaces: TDict[str, Space]):
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def __setitem__(self, key: str, space: Space) -> None:
        self.spaces[key] = space

    def keys(self):
        return self.spaces.keys()

    def seed(self, seed: Optional[int] = None) -> None:
        for space in self.spaces.values():
            space.seed(seed)

    def __repr__(self) -> str:
        return f"Dict({self.spaces})"
