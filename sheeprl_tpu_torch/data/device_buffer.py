"""The replay ring as device tensors (counterpart of
``sheeprl_tpu/data/device_buffer.py::DeviceSequentialReplayBuffer``, single
device; its env-sharded multi-device mode waits for DDP, ROADMAP.md Queue 1).

The host buffer stages every sampled batch to the card: at DV3-S that is
16 x 64 frames of 64x64x3 uint8, 12.6 MB a gradient step, while a policy
step collects 12 KB a env.  This ring keeps everything on the card:

- ``add`` writes one policy step at each env's write head (envs advance
  independently: episode-end rows go only to the envs that finished); host
  leaves cross once, device leaves (the player's actions and state) never
  leave the card;
- ``sample`` draws windows with the host ``SequentialReplayBuffer``'s
  age-space rule (a window never spans an env's write head, its start is
  uniform over the env's valid range), from the same numpy generator in the
  same order as the JAX ring (``_draw_env_idx``, then ``random(n)``), so
  one seed picks the same windows in both; the gather runs on the card and
  returns ``[T, B, ...]`` tensors;
- pixels stay uint8: DV3 Atari-100K (1e5 steps of 64x64x3) is 1.2 GB.

The write heads (per-env ``pos``, ``filled``, ``added``) are host integers:
a few per policy step, and the window draw stays in numpy.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def _as_tensor(value: Any, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device, non_blocking=True)


class DeviceSequentialReplayBuffer:
    """Sequence replay on one device, one write head per env.  The API is
    what the Dreamer loop needs of the host ``EnvIndependentReplayBuffer``:
    ``add(step_data[, indices])``, ``sample(batch_size, sequence_length,
    n_samples)`` (a list of ``n_samples`` batches), ``state_dict`` /
    ``load_state_dict``."""

    def __init__(self, buffer_size: int, n_envs: int = 1, device: torch.device | str = "cpu"):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buffer_size = int(buffer_size)
        self._n_envs = int(n_envs)
        self._device = torch.device(device)
        self._buf: Dict[str, torch.Tensor] = {}
        self._pos = np.zeros(self._n_envs, dtype=np.int64)
        self._filled = np.zeros(self._n_envs, dtype=np.int64)  # rows written, capped at the size
        self._added = np.zeros(self._n_envs, dtype=np.int64)  # rows ever written
        self.dataset_disk_bytes = 0
        self._rng = np.random.default_rng()

    @property
    def buffer(self) -> Dict[str, torch.Tensor]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def empty(self) -> bool:
        return not self._buf

    @property
    def added_steps(self) -> np.ndarray:
        """Per-env rows ever written (monotone; the dataset export's
        cursor: envs advance independently, bookkeeping rows go only to the
        envs that finished an episode)."""
        return self._added.copy()

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    # -- write path ----------------------------------------------------------
    def add(self, data: Dict[str, Any], indices: Optional[Sequence[int]] = None, validate_args: bool = False) -> None:
        """Insert one policy step: ``data`` leaves are ``[1, n_sel, ...]``
        (numpy arrays or tensors), ``n_sel = len(indices)``, all envs when
        ``indices`` is None."""
        del validate_args
        steps = next(iter(data.values())).shape[0]
        if steps != 1:
            raise ValueError(f"DeviceSequentialReplayBuffer.add expects one step at a time, got {steps}")
        envs = np.arange(self._n_envs) if indices is None else np.asarray(list(indices), dtype=np.int64)
        # every add carries the whole key set
        if not self.empty and data.keys() != self._buf.keys():
            raise KeyError(f"add() must provide exactly the buffer's key set {sorted(self._buf)}; got {sorted(data)}")
        for k, v in data.items():
            if k in self._buf:
                continue
            dtype = v.dtype if isinstance(v, torch.Tensor) else torch.from_numpy(np.zeros(0, v.dtype)).dtype
            # storage is at most 32-bit, as in the JAX ring: narrow loudly
            if dtype in (torch.float64, torch.int64):
                narrowed = torch.float32 if dtype == torch.float64 else torch.int32
                warnings.warn(f"DeviceSequentialReplayBuffer: key '{k}' arrives as {dtype} but device storage is "
                              f"32-bit; storing as {narrowed}", UserWarning, stacklevel=2)
                dtype = narrowed
            self._buf[k] = torch.zeros((self._buffer_size, self._n_envs, *v.shape[2:]), dtype=dtype,
                                       device=self._device)
        rows = torch.from_numpy(self._pos[envs] % self._buffer_size).to(self._device)
        cols = torch.from_numpy(envs).to(self._device)
        for k, v in data.items():
            storage = self._buf[k]
            storage[rows, cols] = _as_tensor(v[0], self._device).to(storage.dtype)
        self._pos[envs] = (self._pos[envs] + 1) % self._buffer_size
        self._filled[envs] = np.minimum(self._filled[envs] + 1, self._buffer_size)
        self._added[envs] += 1

    def mark_last_truncated(self, env_idx: int) -> None:
        """Flag one env's newest stored step as truncated, not terminated and
        not a first step (what a ``RestartOnException`` restart leaves)."""
        last = int((self._pos[env_idx] - 1) % self._buffer_size)
        for key, value in (("terminated", 0.0), ("truncated", 1.0), ("is_first", 0.0)):
            if key in self._buf:
                self._buf[key][last, env_idx] = value

    # -- read path -----------------------------------------------------------
    def _draw(self, n: int, seq_len: int):
        """``(starts, env_idx)``: ``n`` windows, in the JAX ring's order of
        draws."""
        if self.empty or self._filled.max(initial=0) == 0:
            raise ValueError("No sample has been added to the buffer. Call 'add' first")
        if seq_len > self._buffer_size:
            raise ValueError(f"The sequence length ({seq_len}) is greater than the buffer size ({self._buffer_size})")
        valid_envs = np.nonzero(self._filled >= seq_len)[0]
        if valid_envs.size == 0:
            raise ValueError(f"Cannot sample a sequence of length {seq_len}. Data added so far: {self._filled.tolist()}")
        env_idx = valid_envs[self._rng.integers(0, valid_envs.size, size=(n,))]
        filled, pos = self._filled[env_idx], self._pos[env_idx]
        start_ages = seq_len - 1 + (self._rng.random(n) * (filled - seq_len + 1)).astype(np.int64)
        starts = np.where(filled >= self._buffer_size, (pos - 1 - start_ages) % self._buffer_size,
                          filled - 1 - start_ages)
        return starts, env_idx

    def sample(self, batch_size: int, sequence_length: int = 1, n_samples: int = 1,
               **_: Any) -> List[Dict[str, torch.Tensor]]:
        """A list of ``n_samples`` batches, each ``{key: [T, batch_size, ...]}``
        on the buffer's device."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        out = []
        offsets = torch.arange(sequence_length, device=self._device)[:, None]
        for _ in range(n_samples):
            starts, env_idx = self._draw(batch_size, sequence_length)
            rows = (torch.from_numpy(starts).to(self._device)[None, :] + offsets) % self._buffer_size  # [T, B]
            cols = torch.from_numpy(env_idx).to(self._device)[None, :]
            out.append({k: v[rows, cols] for k, v in self._buf.items()})
        return out

    # -- checkpointing ---------------------------------------------------------
    def footprint(self) -> Dict[str, int]:
        """Storage bytes on the card (the diagnostics' replay gauge), and
        exported dataset shards as ``dataset_disk``."""
        out = {"device_bytes": sum(v.numel() * v.element_size() for v in self._buf.values())}
        if self.dataset_disk_bytes:
            out["dataset_disk"] = int(self.dataset_disk_bytes)
        return out

    def state_dict(self) -> Dict[str, Any]:
        return {
            "buffer": {k: v.cpu().numpy().copy() for k, v in self._buf.items()},
            "pos": self._pos.copy(),
            "filled": self._filled.copy(),
            "added": self._added.copy(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "DeviceSequentialReplayBuffer":
        """Its own format, or the host ``EnvIndependentReplayBuffer``'s (one
        sub-state per env, stacked here along the env axis), so that a
        checkpoint survives toggling ``buffer.device``."""
        if "buffers" in state:
            subs = state["buffers"]
            if len(subs) != self._n_envs:
                raise ValueError(f"the saved buffer has {len(subs)} envs, this one {self._n_envs}")
            self._buf = {k: _as_tensor(np.concatenate([np.asarray(s["buffer"][k]) for s in subs], axis=1),
                                       self._device) for k in subs[0]["buffer"]}
            self._pos = np.asarray([s["pos"] for s in subs], dtype=np.int64)
            self._filled = np.asarray([self._buffer_size if s["full"] else s["pos"] for s in subs], dtype=np.int64)
            self._added = np.asarray([s.get("added", f) for s, f in zip(subs, self._filled)], dtype=np.int64)
            return self
        self._buf = {k: _as_tensor(v, self._device) for k, v in state["buffer"].items()}
        self._pos = np.asarray(state["pos"], dtype=np.int64).copy()
        self._filled = np.asarray(state["filled"], dtype=np.int64).copy()
        self._added = np.asarray(state.get("added", self._filled), dtype=np.int64).copy()
        return self
