"""Off-critical-path checkpointing (counterpart of
``sheeprl_tpu/resilience/async_writer.py``).

The training loop pays one :func:`host_snapshot` and an enqueue; one
background thread pickles and fsyncs the snapshot through the atomic
tmp+rename of ``utils/checkpoint.py::save_state``, writes the manifest
sidecar and journals ``ckpt_begin`` / ``ckpt_end`` (write time, bytes, time
queued).

PyTorch parameters, Adam states and the device replay ring are updated in
place by the very next step, where JAX arrays are immutable.  So the
snapshot is finished on the calling thread, as full host copies, before
``submit`` returns: a write that read live tensors later would store a torn
checkpoint that its manifest then calls verified.

At most ``max_pending`` snapshots wait; a loop that checkpoints faster than
the disk blocks in ``submit``.  The same thread and queue take other work
through ``submit_task``: the dataset export (``buffer.export``) serializes
its shards there, after the checkpoint it follows.  A failed write journals ``ckpt_end`` with
``status="failed"`` and warns; it never raises into the loop (the next
periodic checkpoint is the retry).
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

#: the queue entry's tag for a :meth:`AsyncCheckpointWriter.submit_task` callable
_TASK = object()


def host_snapshot(tree: Any) -> Any:
    """A self-owned host copy of a checkpoint state tree: every tensor
    copied to a host numpy array (``npify``), every numpy array copied (the
    replay storage and the truncated-flag surgery of the checkpoint callback
    change them right after), containers rebuilt."""
    from sheeprl_tpu_torch.utils.checkpoint import OptaxState, npify

    def copy(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, OptaxState):
            return type(node)(*(copy(v) for v in node.fields))
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields") and type(node) in (list, tuple):
            return type(node)(copy(v) for v in node)
        if isinstance(node, np.ndarray):
            return node.copy()
        out = npify(node)
        if out is not node and getattr(getattr(node, "device", None), "type", None) == "cpu":
            out = out.copy()  # the numpy view of a CPU tensor shares its storage
        return out

    return copy(tree)


class AsyncCheckpointWriter:
    """Background checkpoint writer behind ``ResilienceMonitor.save``.

    ``journal_fn(kind, **fields)`` may be None; ``clock`` is injectable for
    tests."""

    def __init__(
        self,
        journal_fn: Optional[Callable[..., None]] = None,
        max_pending: int = 2,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self._journal_fn = journal_fn
        self.max_pending = max(1, int(max_pending))
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._writing = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None

        self.written_total = 0
        self.failed_total = 0
        self.write_seconds_total = 0.0
        self.last_write_ms: Optional[float] = None
        self.last_step: Optional[int] = None
        self.last_path: Optional[str] = None
        # wall-clock stamps behind the checkpoint age and cadence gauges
        self.last_end_t: Optional[float] = None
        self.last_interval_s: Optional[float] = None

    # -- producer side (the training loop) ----------------------------------
    def submit(self, path: str, state: Mapping[str, Any], step: Optional[int] = None,
               delay_s: Optional[float] = None, group: Optional[Mapping[str, Any]] = None) -> float:
        """Snapshot ``state`` to host and enqueue its write; returns the
        seconds the caller paid.  Blocks only while ``max_pending``
        snapshots already wait.  ``delay_s`` is the chaos ``slow_write``:
        the writer thread sleeps it before the write, off the critical
        path.  ``group`` is the file's group record (a coordinated save's)."""
        t0 = self._clock()
        snapshot = host_snapshot(state)
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            while len(self._queue) >= self.max_pending and not self._closed:
                self._cond.wait(timeout=1.0)
            self._queue.append((str(path), snapshot, step, time.time(), delay_s, group))
            if self._thread is None:
                self._thread = threading.Thread(target=self._worker, name="sheeprl-ckpt-writer", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        return self._clock() - t0

    def submit_task(self, fn: Callable[[], None]) -> None:
        """Enqueue ``fn`` on the writer thread, in the checkpoints' FIFO and
        under their backpressure, drained by ``drain``/``close``.  ``fn`` owns
        what it reads (the dataset export copies its rows before it
        submits).  A failing task warns and is dropped; it never raises into
        the loop."""
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            while len(self._queue) >= self.max_pending and not self._closed:
                self._cond.wait(timeout=1.0)
            self._queue.append((_TASK, fn, None, time.time(), None, None))
            if self._thread is None:
                self._thread = threading.Thread(target=self._worker, name="sheeprl-ckpt-writer", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    # -- consumer side (the writer thread) -----------------------------------
    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(timeout=1.0)
                if not self._queue:
                    return  # closed and drained
                path, snapshot, step, enqueued_t, delay_s, group = self._queue.popleft()
                self._writing = True
                self._cond.notify_all()
            try:
                if path is _TASK:
                    try:
                        snapshot()  # the submitted callable
                    except Exception as err:
                        warnings.warn(f"async writer task failed: {err!r} (the run continues)", RuntimeWarning)
                else:
                    self._write_one(path, snapshot, step, enqueued_t, delay_s, group)
            finally:
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()

    def _write_one(self, path: str, snapshot: Any, step: Optional[int], enqueued_t: float,
                   delay_s: Optional[float] = None, group: Optional[Mapping[str, Any]] = None) -> None:
        from sheeprl_tpu_torch.resilience.manifest import checkpoint_step, save_verified_checkpoint

        if delay_s:
            time.sleep(delay_s)  # chaos slow_write: the cost lands in queued_s and the cadence gauges

        step = step if step is not None else checkpoint_step(path, snapshot)
        queued_s = round(max(0.0, time.time() - enqueued_t), 3)
        self._journal("ckpt_begin", path=path, step=step, blocking=False, queued_s=queued_s)
        try:
            result = save_verified_checkpoint(path, snapshot, step=step, group=group)
        except Exception as err:  # the writer thread must outlive a failed write
            with self._cond:
                self.failed_total += 1
            self._journal("ckpt_end", path=path, step=step, blocking=False, status="failed", error=repr(err)[:200])
            warnings.warn(
                f"async checkpoint write to '{path}' failed: {err!r} "
                "(the run continues; the next periodic checkpoint is the retry)",
                RuntimeWarning,
            )
            return
        now = time.time()
        with self._cond:
            if self.last_end_t is not None:
                self.last_interval_s = round(max(0.0, now - self.last_end_t), 3)
            self.last_end_t = now
            self.written_total += 1
            self.write_seconds_total += result["write_ms"] / 1e3
            self.last_write_ms = result["write_ms"]
            self.last_step = result["step"]
            self.last_path = result["path"]
        self._journal("ckpt_end", blocking=False, status="ok", verified=True, queued_s=queued_s, **result)

    def _journal(self, kind: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(kind, **fields)

    # -- lifecycle -----------------------------------------------------------
    @property
    def busy(self) -> bool:
        with self._cond:
            return bool(self._queue) or self._writing

    def drain(self, timeout: Optional[float] = 120.0) -> bool:
        """Block until every submitted snapshot is on disk (True) or the
        timeout passes (False); preemption calls this so the emergency
        snapshot is durable before the process exits."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._writing:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=min(1.0, remaining) if remaining is not None else 1.0)
        return True

    def close(self, timeout: Optional[float] = 120.0) -> None:
        self.drain(timeout=timeout)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "written_total": self.written_total,
                "failed_total": self.failed_total,
                "write_seconds_total": round(self.write_seconds_total, 3),
                "last_write_ms": self.last_write_ms,
                "last_step": self.last_step,
                "last_path": self.last_path,
                "last_end_t": self.last_end_t,
                "last_interval_s": self.last_interval_s,
            }
