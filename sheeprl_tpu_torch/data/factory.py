"""Replay-buffer selection of the Dreamer loops (counterpart of
``sheeprl_tpu/data/factory.py::make_dreamer_replay_buffer``): the device
ring when ``buffer.device=True`` (``data/device_buffer.py``) and sequential
sampling, else the host buffer, one sequential sub-buffer per env or, with
``buffer_type="episode"`` (DreamerV2's ``buffer.type``), the episode buffer;
memory-mapped as ``buffer.memmap`` says."""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer


def make_dreamer_replay_buffer(cfg, num_envs: int, log_dir: str, buffer_size: int,
                               device: torch.device | str | Sequence[torch.device] = "cpu",
                               buffer_type: str = "sequential", minimum_episode_length: Optional[int] = None,
                               obs_keys: Sequence[str] = ()) -> Tuple[object, bool]:
    """``(rb, device_resident)``.  The ring lives on ``device``, the run's
    device (on the CPU under ``fabric.accelerator=cpu``), or, given the
    data axis's devices (more than one), is sharded by env over them; the
    episode buffer has no ring.  ``buffer.device=True`` falls back to the
    host buffer with a warning where the ring cannot serve, as in the JAX
    package: the episode buffer, or an env count the shard count does not
    divide."""
    if buffer_type not in ("sequential", "episode"):
        raise ValueError(f"Unrecognized buffer type: must be one of `sequential` or `episode`: {buffer_type}")
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    want_device = bool(cfg.buffer.get("device", False))
    if want_device and len(devices) > 1 and num_envs % len(devices) != 0:
        warnings.warn(f"buffer.device=True with {len(devices)} devices needs the mesh and env.num_envs ({num_envs}) "
                      "divisible by the device count; falling back to the host buffer")
        want_device = False
    if want_device and buffer_type != "sequential":
        warnings.warn(f"buffer.device=True requires sequential sampling, got buffer.type={buffer_type!r}; "
                      "falling back to the host buffer")
        want_device = False
    if want_device:
        return DeviceSequentialReplayBuffer(buffer_size, n_envs=num_envs, devices=devices), True
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0")
    if buffer_type == "episode":
        if minimum_episode_length is None:
            raise ValueError("buffer_type='episode' requires minimum_episode_length")
        return EpisodeBuffer(buffer_size, minimum_episode_length, n_envs=num_envs, obs_keys=tuple(obs_keys),
                             prioritize_ends=bool(cfg.buffer.get("prioritize_ends", False)),
                             memmap=cfg.buffer.memmap, memmap_dir=memmap_dir), False
    rb = EnvIndependentReplayBuffer(buffer_size, n_envs=num_envs, memmap=cfg.buffer.memmap, memmap_dir=memmap_dir,
                                    buffer_cls=SequentialReplayBuffer)
    return rb, False
