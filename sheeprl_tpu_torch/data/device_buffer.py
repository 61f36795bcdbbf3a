"""The replay ring as device tensors (counterpart of
``sheeprl_tpu/data/device_buffer.py::DeviceSequentialReplayBuffer``).

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

Over the data axis (``devices`` of more than one shard) the ring is sharded
by env, as the JAX ring is over its mesh: shard d holds the block of envs
``[d * E, (d + 1) * E)`` (``E = n_envs / shards``) on its own device, each
shard's block of a sampled batch is drawn only from its own envs
(block-stratified, the JAX ring's ``_draw_env_idx``), and ``sample`` hands
back each gradient step's batch as the shards' blocks, each gathered on its
shard's device with no copy between devices.

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
    """Sequence replay on the device, one write head per env.  The API is
    what the Dreamer loop needs of the host ``EnvIndependentReplayBuffer``:
    ``add(step_data[, indices])``, ``sample(batch_size, sequence_length,
    n_samples)`` (a list of ``n_samples`` batches), ``state_dict`` /
    ``load_state_dict``.  ``devices`` (more than one) shards the ring by
    env over the data axis; ``device`` is the one device otherwise."""

    def __init__(self, buffer_size: int, n_envs: int = 1, device: torch.device | str = "cpu",
                 devices: Optional[Sequence[torch.device | str]] = None):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buffer_size = int(buffer_size)
        self._n_envs = int(n_envs)
        self._devices = [torch.device(d) for d in devices] if devices else [torch.device(device)]
        self._world = len(self._devices)
        if self._n_envs % self._world != 0:
            raise ValueError(f"n_envs ({self._n_envs}) must be divisible by the mesh size ({self._world}) "
                             "for the env-sharded device buffer")
        self._n_local = self._n_envs // self._world
        # one storage dict a shard: shard d's envs [d * n_local, (d + 1) * n_local)
        self._blocks: List[Dict[str, torch.Tensor]] = [{} for _ in self._devices]
        self._pos = np.zeros(self._n_envs, dtype=np.int64)
        self._filled = np.zeros(self._n_envs, dtype=np.int64)  # rows written, capped at the size
        self._added = np.zeros(self._n_envs, dtype=np.int64)  # rows ever written
        self.dataset_disk_bytes = 0
        self._rng = np.random.default_rng()

    @property
    def buffer(self) -> Dict[str, torch.Tensor]:
        """The storage of shard 0's envs (all of them on one device)."""
        return self._blocks[0]

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def empty(self) -> bool:
        return not self._blocks[0]

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
        if not self.empty and data.keys() != self.buffer.keys():
            raise KeyError(f"add() must provide exactly the buffer's key set {sorted(self.buffer)}; got {sorted(data)}")
        for k, v in data.items():
            if k in self.buffer:
                continue
            dtype = v.dtype if isinstance(v, torch.Tensor) else torch.from_numpy(np.zeros(0, v.dtype)).dtype
            # storage is at most 32-bit, as in the JAX ring: narrow loudly
            if dtype in (torch.float64, torch.int64):
                narrowed = torch.float32 if dtype == torch.float64 else torch.int32
                warnings.warn(f"DeviceSequentialReplayBuffer: key '{k}' arrives as {dtype} but device storage is "
                              f"32-bit; storing as {narrowed}", UserWarning, stacklevel=2)
                dtype = narrowed
            for block, device in zip(self._blocks, self._devices):
                block[k] = torch.zeros((self._buffer_size, self._n_local, *v.shape[2:]), dtype=dtype, device=device)
        rows_all = self._pos[envs] % self._buffer_size
        for d, (block, device) in enumerate(zip(self._blocks, self._devices)):
            mine = np.nonzero(envs // self._n_local == d)[0]
            if mine.size == 0:
                continue
            whole = mine.size == envs.size
            rows = torch.from_numpy(rows_all[mine]).to(device)
            cols = torch.from_numpy(envs[mine] - d * self._n_local).to(device)
            for k, v in data.items():
                step = v[0] if whole else v[0][torch.from_numpy(mine) if isinstance(v, torch.Tensor) else mine]
                block[k][rows, cols] = _as_tensor(step, device).to(block[k].dtype)
        self._pos[envs] = (self._pos[envs] + 1) % self._buffer_size
        self._filled[envs] = np.minimum(self._filled[envs] + 1, self._buffer_size)
        self._added[envs] += 1

    def mark_last_truncated(self, env_idx: int) -> None:
        """Flag one env's newest stored step as truncated, not terminated and
        not a first step (what a ``RestartOnException`` restart leaves)."""
        last = int((self._pos[env_idx] - 1) % self._buffer_size)
        block, col = self._blocks[env_idx // self._n_local], env_idx % self._n_local
        for key, value in (("terminated", 0.0), ("truncated", 1.0), ("is_first", 0.0)):
            if key in block:
                block[key][last, col] = value

    # -- read path -----------------------------------------------------------
    def _draw_env_idx(self, n: int, seq_len: int) -> np.ndarray:
        """The envs of ``n`` windows: uniform over the valid envs on one
        device; over shards, shard d's block of ``n / shards`` drawn only
        from its own envs (block-stratified), as the JAX ring draws them."""
        valid_envs = np.nonzero(self._filled >= seq_len)[0]
        if self._world == 1:
            if valid_envs.size == 0:
                raise ValueError(
                    f"Cannot sample a sequence of length {seq_len}. Data added so far: {self._filled.tolist()}")
            return valid_envs[self._rng.integers(0, valid_envs.size, size=(n,))]
        if n % self._world != 0:
            raise ValueError(f"batch_size ({n}) must be divisible by the mesh size ({self._world})")
        blocks = []
        for d in range(self._world):
            local_valid = valid_envs[(valid_envs >= d * self._n_local) & (valid_envs < (d + 1) * self._n_local)]
            if local_valid.size == 0:
                raise ValueError(f"Cannot sample a sequence of length {seq_len} from device {d}'s env block. "
                                 f"Data added so far: {self._filled.tolist()}")
            blocks.append(local_valid[self._rng.integers(0, local_valid.size, size=(n // self._world,))])
        return np.concatenate(blocks)

    def _draw(self, n: int, seq_len: int):
        """``(starts, env_idx)``: ``n`` windows, in the JAX ring's order of
        draws."""
        if self.empty or self._filled.max(initial=0) == 0:
            raise ValueError("No sample has been added to the buffer. Call 'add' first")
        if seq_len > self._buffer_size:
            raise ValueError(f"The sequence length ({seq_len}) is greater than the buffer size ({self._buffer_size})")
        env_idx = self._draw_env_idx(n, seq_len)
        filled, pos = self._filled[env_idx], self._pos[env_idx]
        start_ages = seq_len - 1 + (self._rng.random(n) * (filled - seq_len + 1)).astype(np.int64)
        starts = np.where(filled >= self._buffer_size, (pos - 1 - start_ages) % self._buffer_size,
                          filled - 1 - start_ages)
        return starts, env_idx

    def _gather(self, d: int, starts: np.ndarray, env_idx: np.ndarray, sequence_length: int):
        device = self._devices[d]
        offsets = torch.arange(sequence_length, device=device)[:, None]
        rows = (torch.from_numpy(starts).to(device)[None, :] + offsets) % self._buffer_size  # [T, B]
        cols = torch.from_numpy(env_idx - d * self._n_local).to(device)[None, :]
        return {k: v[rows, cols] for k, v in self._blocks[d].items()}

    def sample(self, batch_size: int, sequence_length: int = 1, n_samples: int = 1, **_: Any) -> List[Any]:
        """A list of ``n_samples`` batches, each ``{key: [T, batch_size,
        ...]}`` on the buffer's device; over shards each is the list of the
        shards' blocks, block d ``{key: [T, batch_size / shards, ...]}`` on
        shard d's device."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        out = []
        for _ in range(n_samples):
            starts, env_idx = self._draw(batch_size, sequence_length)
            if self._world == 1:
                out.append(self._gather(0, starts, env_idx, sequence_length))
                continue
            b = batch_size // self._world
            out.append([self._gather(d, starts[d * b:(d + 1) * b], env_idx[d * b:(d + 1) * b], sequence_length)
                        for d in range(self._world)])
        return out

    # -- checkpointing ---------------------------------------------------------
    def footprint(self) -> Dict[str, int]:
        """Storage bytes on the card(s) (the diagnostics' replay gauge), and
        exported dataset shards as ``dataset_disk``."""
        out = {"device_bytes": sum(v.numel() * v.element_size() for block in self._blocks for v in block.values())}
        if self.dataset_disk_bytes:
            out["dataset_disk"] = int(self.dataset_disk_bytes)
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The JAX ring's layout: every env's storage along axis 1, the
        shards' blocks in order."""
        return {
            "buffer": {k: np.concatenate([block[k].cpu().numpy() for block in self._blocks], axis=1)
                       for k in self.buffer},
            "pos": self._pos.copy(),
            "filled": self._filled.copy(),
            "added": self._added.copy(),
        }

    def _put(self, storage: Dict[str, np.ndarray]) -> None:
        """``{key: [size, n_envs, ...]}`` into the shards' blocks."""
        n = self._n_local
        self._blocks = [{k: _as_tensor(np.ascontiguousarray(np.asarray(v)[:, d * n:(d + 1) * n]), device)
                         for k, v in storage.items()} for d, device in enumerate(self._devices)]

    def load_state_dict(self, state: Dict[str, Any]) -> "DeviceSequentialReplayBuffer":
        """Its own format, or the host ``EnvIndependentReplayBuffer``'s (one
        sub-state per env, stacked here along the env axis), so that a
        checkpoint survives toggling ``buffer.device`` and the shard count."""
        if "buffers" in state:
            subs = state["buffers"]
            if len(subs) != self._n_envs:
                raise ValueError(f"the saved buffer has {len(subs)} envs, this one {self._n_envs}")
            self._put({k: np.concatenate([np.asarray(s["buffer"][k]) for s in subs], axis=1)
                       for k in subs[0]["buffer"]})
            self._pos = np.asarray([s["pos"] for s in subs], dtype=np.int64)
            self._filled = np.asarray([self._buffer_size if s["full"] else s["pos"] for s in subs], dtype=np.int64)
            self._added = np.asarray([s.get("added", f) for s, f in zip(subs, self._filled)], dtype=np.int64)
            return self
        self._put(state["buffer"])
        self._pos = np.asarray(state["pos"], dtype=np.int64).copy()
        self._filled = np.asarray(state["filled"], dtype=np.int64).copy()
        self._added = np.asarray(state.get("added", self._filled), dtype=np.int64).copy()
        return self
