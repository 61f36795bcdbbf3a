"""Replay-buffer selection of the Dreamer loop (counterpart of
``sheeprl_tpu/data/factory.py::make_dreamer_replay_buffer``): the host
buffer, one sequential sub-buffer per env, memory-mapped as
``buffer.memmap`` says."""

from __future__ import annotations

import os

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer


def make_dreamer_replay_buffer(cfg, num_envs: int, log_dir: str, buffer_size: int) -> EnvIndependentReplayBuffer:
    if bool(cfg.buffer.get("device", False)):
        raise NotImplementedError("buffer.device=True (the device-resident replay ring) is not ported yet: "
                                  "see ROADMAP.md Queue 1")
    return EnvIndependentReplayBuffer(
        buffer_size,
        n_envs=num_envs,
        memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
        buffer_cls=SequentialReplayBuffer,
    )
