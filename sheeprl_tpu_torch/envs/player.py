"""Batched inference helpers of the player loops (counterpart of
``sheeprl_tpu/envs/player.py``'s ``obs_sharding`` / ``fetch_values``).

Two rules keep the host's work per vector step independent of
``num_envs`` and of the number of observation keys:

* **one host-to-device copy of the obs slab per step** (:class:`ObsStager`):
  every key is packed into one pinned host buffer, allocated once per run,
  which crosses to the card in one non-blocking copy; the keys are views of
  the device buffer;
* **one device-to-host fetch of every policy output per step**
  (:func:`fetch_values`): the outputs are packed byte-wise into one device
  buffer that crosses in one blocking copy.

On the CPU both are plain views: nothing crosses.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

_ALIGN = 16  # bytes: every key's view starts aligned for its dtype


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class ObsStager:
    """Stage ``{key: array [N, ...]}`` on ``device`` in one copy.  The
    tensors returned are views of a device buffer that the next call with
    the same layout overwrites (in stream order, after the work queued on
    them), so use them before that call and keep host copies of what must
    last.  Each layout (keys, shapes, dtypes) gets its pinned and device
    buffers once: a loop stages a handful of layouts (the envs' slab, the
    truncated envs' final observations)."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.copies = 0  # host-to-device copies issued
        self._buffers: Dict[Tuple, list] = {}

    def _allocate(self, slab: Mapping[str, np.ndarray]) -> list:
        offset, slots = 0, []
        for key, value in slab.items():
            nbytes = int(value.nbytes)
            slots.append((key, offset, nbytes, tuple(value.shape), value.dtype))
            offset += -(-nbytes // _ALIGN) * _ALIGN
        pinned = torch.empty(max(offset, 1), dtype=torch.uint8, pin_memory=True)
        staged = torch.empty(max(offset, 1), dtype=torch.uint8, device=self.device)
        return [pinned, staged, slots, None]

    def __call__(self, slab: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in slab.items()}
        layout = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in slab.items())
        if layout not in self._buffers:
            self._buffers[layout] = self._allocate(slab)
        entry = self._buffers[layout]
        pinned, staged, slots, copied = entry
        if copied is not None:
            copied.synchronize()  # the previous copy has read the pinned buffer
        host = pinned.numpy()
        for key, offset, nbytes, _, _ in slots:
            host[offset:offset + nbytes] = np.ascontiguousarray(slab[key]).reshape(-1).view(np.uint8)
        staged.copy_(pinned, non_blocking=True)
        self.copies += 1
        entry[3] = torch.cuda.Event()
        entry[3].record()
        return {key: staged[offset:offset + nbytes].view(_torch_dtype(dtype)).view(shape)
                for key, offset, nbytes, shape, dtype in slots}


def fetch_values(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Every tensor to the host as numpy, in argument order, in one blocking
    copy."""
    if not tensors:
        return ()
    if all(t.device.type == "cpu" for t in tensors):
        return tuple(t.detach().numpy() for t in tensors)
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, offset = [], 0
    for t, f in zip(tensors, flat):
        n = int(f.numel())
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out.append(host[offset:offset + n].view(dtype).reshape(tuple(t.shape)))
        offset += n
    return tuple(out)


def host_obs_slab(obs: Mapping[str, np.ndarray], cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (),
                  num_envs: int = 1) -> Dict[str, np.ndarray]:
    """The host obs slab the players stage: pixel keys as raw uint8
    ``[N, C, H, W]``, a frame stack's frames folded into the channels; vector
    keys as float32 ``[N, D]``."""
    out: Dict[str, np.ndarray] = {}
    for k in cnn_keys:
        arr = np.asarray(obs[k])
        out[k] = arr.reshape(num_envs, -1, *arr.shape[-2:])
    for k in mlp_keys:
        out[k] = np.asarray(obs[k], dtype=np.float32).reshape(num_envs, -1)
    return out

