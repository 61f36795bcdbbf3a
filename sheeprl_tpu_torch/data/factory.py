"""Replay-buffer selection of the Dreamer loop (counterpart of
``sheeprl_tpu/data/factory.py::make_dreamer_replay_buffer``): the device
ring when ``buffer.device=True`` (``data/device_buffer.py``), else the host
buffer, one sequential sub-buffer per env, memory-mapped as
``buffer.memmap`` says."""

from __future__ import annotations

import os
from typing import Tuple

import torch

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer


def make_dreamer_replay_buffer(cfg, num_envs: int, log_dir: str, buffer_size: int,
                               device: torch.device | str = "cpu") -> Tuple[object, bool]:
    """``(rb, device_resident)``.  The ring lives on ``device``, the run's
    device (on the CPU under ``fabric.accelerator=cpu``)."""
    if bool(cfg.buffer.get("device", False)):
        return DeviceSequentialReplayBuffer(buffer_size, n_envs=num_envs, device=device), True
    rb = EnvIndependentReplayBuffer(
        buffer_size,
        n_envs=num_envs,
        memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
        buffer_cls=SequentialReplayBuffer,
    )
    return rb, False
