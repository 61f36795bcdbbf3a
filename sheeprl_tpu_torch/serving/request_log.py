"""The request log: every dispatched ``/act`` batch becomes offline training
data (counterpart of ``sheeprl_tpu/serving/request_log.py``).

:class:`RequestLog` appends every dispatched row (the observation as the
policy consumed it, the action it returned, an ``is_first`` episode marker
from the session layer) to a per-model dataset stream in the
``data/datasets.py`` format: ``shard-*.npz`` with manifest sidecars, rotated
every ``serving.request_log.rotate_rows`` rows (journaled
``request_log_rotate``), with the action space (``actions_dim``,
``is_continuous``), the algorithm and the checkpoint in ``dataset.json``.
Either package's ``OfflineDataset`` opens the log as it is, and
``algo.offline`` trains on it.

Rewards and ``terminated`` are zeros: the serving tier does not see returns.
The keys exist so the offline loaders accept the dataset as it is.

Shard writes (npz + sha256) run on a writer thread behind a bounded queue;
the dispatcher only appends to a host buffer.  When the queue is full the
block is shed (journaled ``request_log_rotate`` with ``dropped=true``)
rather than stalling dispatches.  A shard write that fails is not swallowed:
the next ``append`` (and ``close``) raises it.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from sheeprl_tpu_torch.data.datasets import shard_name, write_dataset_meta, write_shard

__all__ = ["RequestLog"]

#: shards waiting for the writer before a full one is shed
MAX_PENDING_SHARDS = 16


class RequestLog:
    """One model's ``/act`` traffic as a growing offline dataset stream."""

    def __init__(
        self,
        root: str,
        handle: Any,
        model: Optional[str] = None,
        rotate_rows: int = 4096,
        journal: Any = None,
        stream: int = 0,
        extra_meta: Optional[Mapping[str, Any]] = None,
        tracer: Any = None,
    ):
        self.root = str(root)
        self.model = model
        self.rotate_rows = max(1, int(rotate_rows))
        self.stream = int(stream)
        self._journal = journal
        self._tracer = tracer
        self._log_row = getattr(handle, "log_row", None)
        self._lock = threading.Lock()
        self._buffer: List[Dict[str, np.ndarray]] = []
        self._start = 0  # logical step cursor of the stream
        self.rows_total = 0
        self.shards_total = 0
        self.dropped_total = 0
        self._error: Optional[BaseException] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=MAX_PENDING_SHARDS)
        self._thread = threading.Thread(target=self._writer, name="sheeprl-request-log", daemon=True)
        os.makedirs(self.root, exist_ok=True)
        handle_meta = getattr(handle, "meta", {}) or {}
        meta: Dict[str, Any] = {
            "source": "serving",
            "model": model,
            "algo": getattr(handle, "algo", None),
            "ckpt": getattr(handle, "ckpt_path", None) or None,
            "actions_dim": handle_meta.get("actions_dim"),
            "is_continuous": handle_meta.get("is_continuous"),
            "obs_keys": sorted(getattr(handle, "obs_spec", {}) or {}),
        }
        meta.update(dict(extra_meta or {}))
        write_dataset_meta(self.root, meta)
        self._thread.start()

    # -- dispatcher side -----------------------------------------------------
    def append(
        self,
        obs_rows: List[Dict[str, np.ndarray]],
        actions: np.ndarray,
        is_first: Optional[np.ndarray] = None,
    ) -> None:
        """Buffer one dispatched batch (valid rows only, the padding sliced
        off).  ``is_first`` is ``[rows, 1]`` from the session layer; a
        stateless dispatch logs ones (each request its own one-step
        episode)."""
        self._raise_failed_write()
        actions = np.asarray(actions)
        blocks: List[Dict[str, np.ndarray]] = []
        for i, row in enumerate(obs_rows):
            stored = dict(self._log_row(row)) if self._log_row is not None else dict(row)
            stored["actions"] = np.asarray(actions[i], dtype=np.float32)
            stored["rewards"] = np.zeros((1,), np.float32)
            stored["terminated"] = np.zeros((1,), np.float32)
            stored["is_first"] = (np.ones((1,), np.float32) if is_first is None
                                  else np.asarray(is_first[i], np.float32).reshape(1))
            blocks.append(stored)
        full: Optional[List[Dict[str, np.ndarray]]] = None
        with self._lock:
            self._buffer.extend(blocks)
            self.rows_total += len(blocks)
            if len(self._buffer) >= self.rotate_rows:
                full, self._buffer = self._buffer, []
        if full:
            self._enqueue(full)

    def _enqueue(self, rows: List[Dict[str, np.ndarray]]) -> None:
        try:
            self._queue.put_nowait(rows)
        except queue.Full:
            # the disk cannot keep up: shed this block rather than stall
            # dispatches or grow without bound
            with self._lock:
                self.dropped_total += len(rows)
            if self._journal is not None:
                self._journal.write("request_log_rotate", model=self.model, stream=self.stream, rows=len(rows),
                                    dropped=True)

    # -- writer thread -------------------------------------------------------
    def _writer(self) -> None:
        while True:
            rows = self._queue.get()
            if rows is None:
                return
            try:
                if self._tracer is not None:
                    # shard I/O on the writer thread's track of the serving trace
                    with self._tracer.span("serve-request-log", rows=len(rows), model=self.model):
                        self._write_shard(rows)
                else:
                    self._write_shard(rows)
            except BaseException as err:  # noqa: BLE001 - kept and raised on the dispatcher's next append
                with self._lock:
                    self._error = err
                return

    def _raise_failed_write(self) -> None:
        """Raise the writer thread's failure, if a shard write failed."""
        with self._lock:
            error = self._error
        if error is not None:
            raise RuntimeError(f"request log {self.root!r}: a shard write failed") from error

    def _write_shard(self, rows: List[Dict[str, np.ndarray]]) -> None:
        arrays = {k: np.stack([r[k] for r in rows], axis=0) for k in rows[0]}
        start = self._start
        self._start += len(rows)
        entry = write_shard(self.root, self.stream, start, arrays)
        with self._lock:
            self.shards_total += 1
        if self._journal is not None:
            self._journal.write(
                "request_log_rotate",
                model=self.model,
                stream=self.stream,
                rows=int(entry["rows"]),
                bytes=int(entry["bytes"]),
                start=int(entry["start"]),
                path=shard_name(self.stream, start),
                shards=self.shards_total,
            )

    # -- lifecycle -----------------------------------------------------------
    def flush(self) -> None:
        """Rotate whatever is buffered (a partial shard is fine: shards only
        need a consistent time axis)."""
        with self._lock:
            rows, self._buffer = self._buffer, []
        if rows:
            self._enqueue(rows)

    def close(self) -> None:
        """Flush, drain the writer and join it; raise a failed shard write."""
        if self._thread.is_alive():
            self.flush()
            while self._thread.is_alive():  # every queued shard lands before the sentinel
                try:
                    self._queue.put(None, timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._thread.join()
        self._raise_failed_write()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rows_total": self.rows_total,
                "shards_total": self.shards_total,
                "dropped_total": self.dropped_total,
                "buffered": len(self._buffer),
            }
