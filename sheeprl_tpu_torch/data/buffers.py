"""Replay buffers: host-side numpy storage, optionally memory-mapped
(counterpart of ``sheeprl_tpu/data/buffers.py``).

The same ``[time, n_envs, ...]`` layout and the same sampling, draw for draw
from a seeded ``numpy`` generator, as the JAX package's ``ReplayBuffer``,
``SequentialReplayBuffer``, ``EnvIndependentReplayBuffer`` and
``EpisodeBuffer``.  Only the sampled minibatch crosses to the device, staged
by the training loop.  The device-resident ring (``buffer.device=True``) is
``data/device_buffer.py``.
"""

from __future__ import annotations

import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from sheeprl_tpu_torch.data.memmap import _ALLOWED_MODES, MemmapArray


def _validate_add_data(data: Dict[str, np.ndarray]) -> None:
    if not isinstance(data, dict):
        raise ValueError(f"'data' must be a dictionary containing Numpy arrays, got type '{type(data)}'")
    for k, v in data.items():
        if not isinstance(v, np.ndarray):
            raise ValueError(f"'data' must contain Numpy arrays. Key '{k}' has type '{type(v)}'")
        if v.ndim < 2:
            raise RuntimeError(f"'data' must have at least 2 dims [time, n_envs, ...]; '{k}' has shape {v.shape}")
    shapes = {k: v.shape[:2] for k, v in data.items()}
    if len(set(shapes.values())) > 1:
        raise RuntimeError(f"Every array in 'data' must agree in the first 2 dims, got {shapes}")


def _with_dataset_disk(out: Dict[str, int], buffer: Any) -> Dict[str, int]:
    """``out`` with the buffer's exported dataset bytes as ``dataset_disk``
    (``offline/export.py::note_dataset_bytes``), when it has any."""
    if buffer.dataset_disk_bytes:
        out["dataset_disk"] = int(buffer.dataset_disk_bytes)
    return out


class ReplayBuffer:
    """Circular buffer over dict-of-ndarray storage; :meth:`sample` draws
    uniformly, with the ``next_<key>`` of each of ``obs_keys`` on request."""

    batch_axis: int = 1

    def __init__(self, buffer_size: int, n_envs: int = 1, memmap: bool = False,
                 memmap_dir: str | os.PathLike | None = None, obs_keys: Sequence[str] = ("observations",)):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._memmap = memmap
        self._memmap_dir = memmap_dir
        if self._memmap:
            if memmap_dir is None:
                raise ValueError("memmap=True requires a 'memmap_dir'")
            self._memmap_dir = Path(memmap_dir)
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._buf: Dict[str, np.ndarray | MemmapArray] = {}
        self._pos = 0
        self._full = False
        # steps ever added: the logical stream clock the incremental dataset
        # export (offline/export.py) keeps its cursors against
        self._added = 0
        # bytes of exported dataset shards attributed to this buffer
        self.dataset_disk_bytes = 0
        self._rng: np.random.Generator = np.random.default_rng()

    @property
    def buffer(self) -> Dict[str, np.ndarray | MemmapArray]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def empty(self) -> bool:
        return len(self._buf) == 0

    @property
    def full(self) -> bool:
        return self._full

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def added_steps(self) -> int:
        """Steps ever added (monotone; once full, ``added_steps -
        buffer_size`` is the oldest logical step still in the ring)."""
        return self._added

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    def flush(self) -> None:
        """Memmap-backed storage to disk, before an export reads it."""
        for v in self._buf.values():
            if isinstance(v, MemmapArray):
                v.flush()

    def _allocate(self, key: str, per_step_shape: tuple, dtype: Any) -> None:
        full_shape = (self._buffer_size, self._n_envs, *per_step_shape)
        if self._memmap:
            self._buf[key] = MemmapArray(shape=full_shape, dtype=dtype, filename=Path(self._memmap_dir) / f"{key}.memmap")
        else:
            self._buf[key] = np.empty(shape=full_shape, dtype=dtype)

    def add(self, data: Dict[str, np.ndarray], validate_args: bool = False) -> None:
        """Insert ``[T, n_envs, ...]`` rows at the write head, wrapping; an
        add longer than the buffer keeps its newest ``buffer_size`` rows."""
        if validate_args:
            _validate_add_data(data)
        steps = next(iter(data.values())).shape[0]
        if steps > self._buffer_size:
            data = {k: v[steps - self._buffer_size :] for k, v in data.items()}
            steps = self._buffer_size
        head = self._pos
        tail_span = min(steps, self._buffer_size - head)
        was_empty = self.empty
        for k, v in data.items():
            if k not in self._buf:
                if not was_empty:
                    raise KeyError(f"Unknown buffer key '{k}'; the buffer was initialized with {sorted(self._buf)}")
                self._allocate(k, v.shape[2:], v.dtype)
            storage = self._buf[k]
            storage[head : head + tail_span] = v[:tail_span]
            if steps > tail_span:
                storage[: steps - tail_span] = v[tail_span:]
        if head + steps >= self._buffer_size:
            self._full = True
        self._pos = (head + steps) % self._buffer_size
        self._added += steps

    def sample(self, batch_size: int, sample_next_obs: bool = False, clone: bool = False,
               n_samples: int = 1) -> Dict[str, np.ndarray]:
        """``[n_samples, batch_size, ...]`` rows drawn uniformly: the rows
        first, then the envs, from the buffer's generator.  With
        ``sample_next_obs`` each of ``obs_keys`` also comes as
        ``next_<key>``, the row after; the newest row has no successor, so
        a full buffer draws a row's age in ``[1, size)``, a part-full one a
        row below ``pos - 1``.  The rows are copies (``np.take``), so
        ``clone`` changes nothing; it is the JAX signature's."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer. Call 'add' first")
        draw = batch_size * n_samples
        if self._full:
            if sample_next_obs:
                ages = self._rng.integers(1, self._buffer_size, size=(draw,), dtype=np.intp)
                batch_idxes = (self._pos - 1 - ages) % self._buffer_size
            else:
                batch_idxes = self._rng.integers(0, self._buffer_size, size=(draw,), dtype=np.intp)
        else:
            stored = self._pos - 1 if sample_next_obs else self._pos
            if stored == 0:
                raise RuntimeError("Cannot sample next observations with a single stored step; add at least two steps")
            batch_idxes = self._rng.integers(0, stored, size=(draw,), dtype=np.intp)
        env_idxes = self._rng.integers(0, self._n_envs, size=(draw,), dtype=np.intp)
        flat_idxes = batch_idxes * self._n_envs + env_idxes
        flat_next = ((batch_idxes + 1) % self._buffer_size) * self._n_envs + env_idxes
        samples: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            flat_v = np.reshape(np.asarray(v), (-1, *v.shape[2:]))
            samples[k] = np.take(flat_v, flat_idxes, axis=0)
            if sample_next_obs and k in self._obs_keys:
                samples[f"next_{k}"] = np.take(flat_v, flat_next, axis=0)
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in samples.items()}

    def footprint(self) -> Dict[str, int]:
        """Storage bytes by residence: memmap-backed keys as ``disk_bytes``,
        in-memory ones as ``host_bytes`` (the diagnostics' replay gauges);
        exported dataset shards as ``dataset_disk``."""
        host = sum(int(v.nbytes) for v in self._buf.values() if not isinstance(v, MemmapArray))
        disk = sum(int(v.nbytes) for v in self._buf.values() if isinstance(v, MemmapArray))
        return _with_dataset_disk({"host_bytes": host, "disk_bytes": disk}, self)

    def state_dict(self) -> Dict[str, Any]:
        return {"buffer": {k: np.asarray(v).copy() for k, v in self._buf.items()}, "pos": self._pos,
                "full": self._full, "added": self._added}

    def load_state_dict(self, state: Dict[str, Any]) -> "ReplayBuffer":
        for k, v in state["buffer"].items():
            if self._memmap:
                self._buf[k] = MemmapArray.from_array(v, filename=Path(self._memmap_dir) / f"{k}.memmap")
            else:
                self._buf[k] = np.array(v)  # a copy: checkpoint arrays may be read-only
        self._pos = int(state["pos"])
        self._full = bool(state["full"])
        # a checkpoint without the counter: the stored span is the best bound
        self._added = int(state.get("added", self._buffer_size if self._full else self._pos))
        return self


class SequentialReplayBuffer(ReplayBuffer):
    """Samples fixed-length contiguous sequences, ignoring episode bounds:
    ``[n_samples, sequence_length, batch_size, ...]``."""

    batch_axis: int = 2

    def sample(self, batch_size: int, n_samples: int = 1, sequence_length: int = 1) -> Dict[str, np.ndarray]:
        batch_dim = batch_size * n_samples
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer. Call 'add' first")
        if not self._full and self._pos - sequence_length + 1 < 1:
            raise ValueError(f"Cannot sample a sequence of length {sequence_length}. Data added so far: {self._pos}")
        if self._full and sequence_length > self._buffer_size:
            raise ValueError(
                f"The sequence length ({sequence_length}) is greater than the buffer size ({self._buffer_size})"
            )
        if self._full:
            # a window lies inside the logical stream: its start's age (the
            # newest row is age 0) is in [sequence_length - 1, size)
            start_ages = self._rng.integers(sequence_length - 1, self._buffer_size, size=(batch_dim,), dtype=np.intp)
            start_idxes = (self._pos - 1 - start_ages) % self._buffer_size
        else:
            start_idxes = self._rng.integers(0, self._pos - sequence_length + 1, size=(batch_dim,), dtype=np.intp)
        idxes = (start_idxes[:, None] + np.arange(sequence_length, dtype=np.intp)[None, :]) % self._buffer_size
        flat_batch_idxes = np.ravel(idxes)
        if self._n_envs == 1:
            env_idxes = np.zeros((batch_dim * sequence_length,), dtype=np.intp)
        else:
            env_idxes = self._rng.integers(0, self._n_envs, size=(batch_dim,), dtype=np.intp)
            env_idxes = np.ravel(np.tile(env_idxes.reshape(-1, 1), (1, sequence_length)))
        flat_idxes = flat_batch_idxes * self._n_envs + env_idxes
        samples: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            taken = np.take(np.reshape(np.asarray(v), (-1, *v.shape[2:])), flat_idxes, axis=0)
            batched = np.reshape(taken, (n_samples, batch_size, sequence_length) + taken.shape[1:])
            samples[k] = np.swapaxes(batched, 1, 2)
        return samples


class EnvIndependentReplayBuffer:
    """One sub-buffer per environment: envs finish episodes at different
    times, and each keeps its own write head."""

    def __init__(self, buffer_size: int, n_envs: int = 1, memmap: bool = False,
                 memmap_dir: str | os.PathLike | None = None, buffer_cls: Type[ReplayBuffer] = SequentialReplayBuffer):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap and memmap_dir is None:
            raise ValueError("memmap=True requires a 'memmap_dir'")
        self._buf: List[ReplayBuffer] = [
            buffer_cls(buffer_size=buffer_size, n_envs=1, memmap=memmap,
                       memmap_dir=Path(memmap_dir) / f"env_{i}" if memmap else None)
            for i in range(n_envs)
        ]
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._rng: np.random.Generator = np.random.default_rng()
        self._concat_along_axis = buffer_cls.batch_axis
        self.dataset_disk_bytes = 0

    @property
    def buffer(self) -> Sequence[ReplayBuffer]:
        return tuple(self._buf)

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i)

    def flush(self) -> None:
        for b in self._buf:
            b.flush()

    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None,
            validate_args: bool = False) -> None:
        """Column ``j`` of ``data`` goes to the sub-buffer of env
        ``indices[j]`` (all envs by default)."""
        if indices is None:
            indices = tuple(range(self._n_envs))
        elif len(indices) != next(iter(data.values())).shape[1]:
            raise ValueError(
                f"The length of 'indices' ({len(indices)}) must equal the env dim of 'data' "
                f"({next(iter(data.values())).shape[1]})"
            )
        if validate_args:
            _validate_add_data(data)
        for data_idx, env_idx in enumerate(indices):
            self._buf[env_idx].add({k: v[:, data_idx : data_idx + 1] for k, v in data.items()})

    def sample(self, batch_size: int, n_samples: int = 1, **kwargs: Any) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        bs_per_buf = np.bincount(self._rng.integers(0, self._n_envs, (batch_size,)), minlength=self._n_envs)
        per_buf = [
            b.sample(batch_size=int(bs), n_samples=n_samples, **kwargs) for b, bs in zip(self._buf, bs_per_buf) if bs > 0
        ]
        return {k: np.concatenate([s[k] for s in per_buf], axis=self._concat_along_axis) for k in per_buf[0]}

    def footprint(self) -> Dict[str, int]:
        out = {"host_bytes": 0, "disk_bytes": 0}
        for b in self._buf:
            for kind, size in b.footprint().items():
                out[kind] = out.get(kind, 0) + size
        if self.dataset_disk_bytes:
            out["dataset_disk"] = out.get("dataset_disk", 0) + int(self.dataset_disk_bytes)
        return out

    def state_dict(self) -> Dict[str, Any]:
        return {"buffers": [b.state_dict() for b in self._buf]}

    def load_state_dict(self, state: Dict[str, Any]) -> "EnvIndependentReplayBuffer":
        """Its own format, or the device ring's (``filled`` per env over
        storage stacked along the env axis), so that a checkpoint survives
        toggling ``buffer.device``."""
        if "filled" in state:
            for e, b in enumerate(self._buf):
                b.load_state_dict({
                    "buffer": {k: np.asarray(v[:, e : e + 1]) for k, v in state["buffer"].items()},
                    "pos": int(state["pos"][e]),
                    "full": bool(state["filled"][e] >= self._buffer_size),
                })
            return self
        if len(state["buffers"]) != self._n_envs:
            raise ValueError(f"the saved buffer has {len(state['buffers'])} envs, this one {self._n_envs}")
        for b, s in zip(self._buf, state["buffers"]):
            b.load_state_dict(s)
        return self


class EpisodeBuffer:
    """Whole episodes: each env's steps gather in an open episode until one
    ends (``terminated`` or ``truncated``), which is then stored; storing
    past ``buffer_size`` steps evicts the oldest episodes.  :meth:`sample`
    draws episodes, then each sequence's start inside its episode, from the
    buffer's generator, as the JAX package's ``EpisodeBuffer`` does; with
    ``prioritize_ends`` a start past the last full window clamps to it, so
    the episodes' ends come up more often."""

    batch_axis: int = 2

    def __init__(self, buffer_size: int, minimum_episode_length: int, n_envs: int = 1,
                 obs_keys: Sequence[str] = ("observations",), prioritize_ends: bool = False, memmap: bool = False,
                 memmap_dir: str | os.PathLike | None = None, memmap_mode: str = "r+"):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if minimum_episode_length <= 0:
            raise ValueError(f"The sequence length must be greater than zero, got: {minimum_episode_length}")
        if buffer_size < minimum_episode_length:
            raise ValueError(f"The sequence length must be lower than the buffer size, got: bs = {buffer_size} "
                             f"and sl = {minimum_episode_length}")
        self._buffer_size = buffer_size
        self._minimum_episode_length = minimum_episode_length
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self.prioritize_ends = prioritize_ends
        self._open_episodes: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(n_envs)]
        self._cum_lengths: List[int] = []
        self._buf: List[Dict[str, np.ndarray | MemmapArray]] = []
        # a monotone id per stored episode (parallel to _buf), as the JAX
        # buffer keeps them
        self._episode_ids: List[int] = []
        self._episodes_saved = 0
        self.dataset_disk_bytes = 0
        self._memmap = memmap
        self._memmap_dir = memmap_dir
        self._memmap_mode = memmap_mode
        self._rng: np.random.Generator = np.random.default_rng()
        if self._memmap:
            if memmap_mode not in _ALLOWED_MODES:
                raise ValueError(f"Accepted values for memmap_mode are {_ALLOWED_MODES}")
            if memmap_dir is None:
                raise ValueError("memmap=True requires a 'memmap_dir'")
            self._memmap_dir = Path(memmap_dir)
            self._memmap_dir.mkdir(parents=True, exist_ok=True)

    @property
    def buffer(self) -> Sequence[Dict[str, np.ndarray | MemmapArray]]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def full(self) -> bool:
        return self._cum_lengths[-1] + self._minimum_episode_length > self._buffer_size if self._buf else False

    @property
    def episode_ids(self) -> Sequence[int]:
        """A monotone id per stored episode (parallel to :attr:`buffer`)."""
        return tuple(self._episode_ids)

    def __len__(self) -> int:
        return self._cum_lengths[-1] if self._buf else 0

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    def flush(self) -> None:
        for episode in self._buf:
            for v in episode.values():
                if isinstance(v, MemmapArray):
                    v.flush()

    def add(self, data: Dict[str, np.ndarray], env_idxes: Optional[Sequence[int]] = None,
            validate_args: bool = False) -> None:
        """Column ``i`` of the ``[T, n, ...]`` ``data`` extends the open
        episode of env ``env_idxes[i]`` (all envs by default); every episode
        that ends in it is stored."""
        if validate_args:
            _validate_add_data(data)
            if "terminated" not in data and "truncated" not in data:
                raise RuntimeError(
                    f"The episode must contain the `terminated` and the `truncated` keys, got: {data.keys()}")
            if env_idxes is not None and (np.array(env_idxes) >= self._n_envs).any():
                raise ValueError(f"Env indices must be in [0, {self._n_envs}), given {env_idxes}")
        if env_idxes is None:
            env_idxes = range(self._n_envs)
        for i, env in enumerate(env_idxes):
            env_data = {k: v[:, i] for k, v in data.items()}
            ends = np.logical_or(env_data["terminated"], env_data["truncated"]).reshape(len(env_data["terminated"]), -1)
            ends = ends.any(axis=-1).nonzero()[0].tolist()
            start = 0
            for stop in ends:
                self._open_episodes[env].append({k: np.array(v[start : stop + 1]) for k, v in env_data.items()})
                self._save_episode(self._open_episodes[env])
                self._open_episodes[env] = []
                start = stop + 1
            if start < len(env_data["terminated"]):
                self._open_episodes[env].append({k: np.array(v[start:]) for k, v in env_data.items()})

    def mark_last_truncated(self, env: int) -> None:
        """End env ``env``'s open episode at its last stored step, as a
        truncation (an env restarted under it); stored if long enough."""
        chunks = self._open_episodes[env]
        if not chunks:
            return
        last = chunks[-1]
        last["terminated"][-1] = 0
        last["truncated"][-1] = 1
        if "is_first" in last:
            last["is_first"][-1] = 0
        if sum(len(c["terminated"]) for c in chunks) >= self._minimum_episode_length:
            self._save_episode(chunks)
        self._open_episodes[env] = []

    def _save_episode(self, chunks: Sequence[Dict[str, np.ndarray]]) -> None:
        episode = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
        ends = np.logical_or(episode["terminated"], episode["truncated"])
        ep_len = ends.shape[0]
        if len(ends.nonzero()[0]) != 1 or not ends[-1]:
            raise RuntimeError("The episode must contain exactly one done at its end")
        if ep_len < self._minimum_episode_length:
            raise RuntimeError(f"Episode too short (at least {self._minimum_episode_length} steps), got: {ep_len}")
        if ep_len > self._buffer_size:
            raise RuntimeError(f"Episode too long (at most {self._buffer_size} steps), got: {ep_len}")
        if self.full or len(self) + ep_len > self._buffer_size:
            # evict the oldest episodes, the fewest that make room
            cum_lengths = np.array(self._cum_lengths)
            last = int(((len(self) - cum_lengths + ep_len) <= self._buffer_size).argmax())
            for evicted in self._buf[: last + 1]:
                if self._memmap:
                    shutil.rmtree(os.path.dirname(next(iter(evicted.values())).filename), ignore_errors=True)
            self._buf = self._buf[last + 1 :]
            self._episode_ids = self._episode_ids[last + 1 :]
            self._cum_lengths = (cum_lengths[last + 1 :] - cum_lengths[last]).tolist()
        self._cum_lengths.append(len(self) + ep_len)
        self._buf.append(self._stored(episode))
        self._episode_ids.append(self._episodes_saved)
        self._episodes_saved += 1

    def _stored(self, episode: Dict[str, np.ndarray]) -> Dict[str, np.ndarray | MemmapArray]:
        if not self._memmap:
            return {k: np.array(v) for k, v in episode.items()}
        episode_dir = Path(self._memmap_dir) / f"episode_{uuid.uuid4()}"
        episode_dir.mkdir(parents=True, exist_ok=True)
        return {k: MemmapArray.from_array(v, filename=episode_dir / f"{k}.memmap", mode=self._memmap_mode)
                for k, v in episode.items()}

    def sample(self, batch_size: int, sample_next_obs: bool = False, n_samples: int = 1, clone: bool = False,
               sequence_length: int = 1) -> Dict[str, np.ndarray]:
        """``[n_samples, sequence_length, batch_size, ...]``: the episodes
        (of at least ``sequence_length`` steps, more with
        ``sample_next_obs``) drawn uniformly, then one start per sequence
        inside its episode; ``clone`` is the JAX signature's (the rows are
        copies)."""
        if batch_size <= 0:
            raise ValueError(f"Batch size must be greater than 0, got: {batch_size}")
        if n_samples <= 0:
            raise ValueError(f"The number of samples must be greater than 0, got: {n_samples}")
        ep_lengths = np.array(self._cum_lengths) - np.array([0] + self._cum_lengths[:-1])
        valid_mask = ep_lengths > sequence_length if sample_next_obs else ep_lengths >= sequence_length
        valid = [ep for ep, ok in zip(self._buf, valid_mask) if ok]
        if not valid:
            raise RuntimeError(
                f"No valid episodes in the buffer: add at least one episode of length >= {sequence_length}")
        chunk = np.arange(sequence_length, dtype=np.intp).reshape(1, -1)
        per_episode = np.bincount(self._rng.integers(0, len(valid), (batch_size * n_samples,)), minlength=len(valid))
        keys = list(valid[0])
        gathered: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
        if sample_next_obs:
            gathered.update({f"next_{k}": [] for k in self._obs_keys})
        for ep, n in zip(valid, per_episode):
            if n == 0:
                continue
            ep_len = len(ep["terminated"]) - int(sample_next_obs)
            upper = ep_len - sequence_length + 1 + (sequence_length if self.prioritize_ends else 0)
            starts = np.minimum(self._rng.integers(0, upper, size=(n,)).reshape(-1, 1), ep_len - sequence_length)
            indices = starts.astype(np.intp) + chunk
            for k in keys:
                arr = np.asarray(ep[k])
                gathered[k].append(np.take(arr, indices.ravel(), axis=0).reshape(n, sequence_length, *arr.shape[1:]))
                if sample_next_obs and k in self._obs_keys:
                    gathered[f"next_{k}"].append(arr[indices + 1])
        return {k: np.moveaxis(np.concatenate(v, axis=0).reshape(n_samples, batch_size, sequence_length,
                                                                 *v[0].shape[2:]), 2, 1)
                for k, v in gathered.items() if v}

    def footprint(self) -> Dict[str, int]:
        """Stored episodes by residence, and the open episodes' chunks
        (host memory)."""
        host = disk = 0
        for ep in self._buf:
            for v in ep.values():
                if isinstance(v, MemmapArray):
                    disk += v.nbytes
                else:
                    host += int(np.asarray(v).nbytes)
        host += sum(int(np.asarray(v).nbytes) for chunks in self._open_episodes for c in chunks for v in c.values())
        return _with_dataset_disk({"host_bytes": host, "disk_bytes": disk}, self)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "buffer": [{k: np.asarray(v).copy() for k, v in ep.items()} for ep in self._buf],
            "cum_lengths": list(self._cum_lengths),
            "open_episodes": self._open_episodes,
            "episode_ids": list(self._episode_ids),
            "episodes_saved": self._episodes_saved,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "EpisodeBuffer":
        episodes = state["buffer"]
        self._cum_lengths = list(state["cum_lengths"])
        self._episode_ids = list(state.get("episode_ids", range(len(episodes))))
        self._episodes_saved = int(state.get("episodes_saved", len(episodes)))
        self._buf = [self._stored(ep) for ep in episodes]
        self._open_episodes = [[{k: np.array(v) for k, v in c.items()} for c in chunks]
                               for chunks in state.get("open_episodes", [[] for _ in range(self._n_envs)])]
        return self
