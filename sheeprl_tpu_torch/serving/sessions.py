"""The serving session layer: device-resident recurrent state for stateful
policies (counterpart of ``sheeprl_tpu/serving/sessions.py``).

:class:`SessionStore` holds

* a fixed-capacity **state slab** — one ``[capacity + 1, ...]`` device tensor
  per ``state_spec`` key.  Row ``capacity`` is the **scratch slot**: padding
  rows and sessionless one-shot requests gather/scatter there with
  ``is_first = 1`` forced, so whatever the slot holds is reset before it can
  influence an action;
* a host-side **LRU table** mapping client session ids to slots.  A new
  session takes the lowest free slot; when the slab is full the
  least-recently used session NOT in the current batch is evicted.  An
  evicted session that comes back is a new session: fresh slot,
  ``is_first = 1``.

The dispatcher thread is the only writer of the slab; ``checkout`` runs under
the table lock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def make_slab_step(state_step: Callable) -> Callable:
    """Wrap a per-row state step into the slab signature: ``(params, slab,
    idx, obs, is_first, generator, noise=None) -> actions``.  The gather is
    ``slab[k][idx]``; the scatter writes the new state back into the slab IN
    PLACE with ``index_copy_``.

    Duplicate indices only ever point at the scratch slot (the batcher's
    session group key keeps real sessions unique per batch).  On CUDA the
    order in which duplicate rows land is unspecified, which is harmless
    there: scratch is reset before every use.
    """

    def step(params, slab, idx, obs, is_first, generator, noise=None):
        state = {k: v[idx] for k, v in slab.items()}
        actions, new_state = state_step(params, state, obs, is_first, generator, noise)
        for k, v in slab.items():
            v.index_copy_(0, idx, new_state[k].to(v.dtype))
        return actions

    return step


class SessionStore:
    """Fixed-capacity session table + device state slab."""

    def __init__(
        self,
        state_spec: Dict[str, Tuple[Tuple[int, ...], str]],
        capacity: int,
        device: torch.device | str = "cpu",
    ):
        if capacity <= 0:
            raise ValueError(f"sessions.capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self.scratch = self.capacity  # slot index of the scratch row
        self.state_spec = dict(state_spec)
        rows = self.capacity + 1
        self.slab: Dict[str, torch.Tensor] = {
            k: torch.zeros((rows,) + tuple(shape), dtype=getattr(torch, dtype), device=device)
            for k, (shape, dtype) in self.state_spec.items()
        }
        self._lru: "OrderedDict[str, int]" = OrderedDict()  # session id -> slot
        self._free: List[int] = list(range(self.capacity))
        self._lock = threading.Lock()
        self.created_total = 0
        self.evictions_total = 0
        self.overflow_total = 0

    def checkout(
        self,
        session_ids: Sequence[Optional[str]],
        resets: Sequence[bool],
        width: int,
    ) -> Tuple[np.ndarray, np.ndarray, List[Dict[str, Any]]]:
        """Resolve one batch: ``(idx [width] int64, is_first [width, 1]
        float32, evicted records)``.  Padding rows map to scratch with
        ``is_first = 1``; so do sessionless rows and — when every slot is
        pinned by this very batch — overflow sessions."""
        idx = np.full((int(width),), self.scratch, dtype=np.int64)
        is_first = np.ones((int(width), 1), dtype=np.float32)
        evicted: List[Dict[str, Any]] = []
        with self._lock:
            busy = {self._lru[s] for s in session_ids if s is not None and s in self._lru}
            for i, (sid, reset) in enumerate(zip(session_ids, resets)):
                if sid is None:
                    continue  # one-shot row: scratch + reset
                slot = self._lru.get(sid)
                if slot is None:
                    slot = self._allocate(sid, busy, evicted)
                    if slot is None:
                        self.overflow_total += 1
                        continue  # slab fully pinned by this batch: scratch
                    busy.add(slot)
                else:
                    self._lru.move_to_end(sid)
                    is_first[i, 0] = 1.0 if reset else 0.0
                idx[i] = slot
        return idx, is_first, evicted

    def _allocate(self, sid: str, busy: set, evicted: List[Dict[str, Any]]) -> Optional[int]:
        """Lowest free slot, else evict the LRU session not pinned by the
        current batch.  Caller holds the lock."""
        if self._free:
            slot = self._free.pop(0)
        else:
            victim = next((s for s in self._lru if self._lru[s] not in busy), None)
            if victim is None:
                return None
            slot = self._lru.pop(victim)
            self.evictions_total += 1
            evicted.append(
                {"session": victim, "slot": int(slot), "resident": len(self._lru), "capacity": self.capacity}
            )
        self._lru[sid] = slot
        self.created_total += 1
        return slot

    def drop(self, session_id: str) -> bool:
        """Explicit release (client says goodbye)."""
        with self._lock:
            slot = self._lru.pop(session_id, None)
            if slot is None:
                return False
            self._free.append(slot)
            self._free.sort()
            return True

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._lru)

    def sessions(self) -> List[str]:
        with self._lock:
            return list(self._lru)
