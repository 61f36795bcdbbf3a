"""Replay -> durable dataset export (counterpart of
``sheeprl_tpu/offline/export.py``).

Three producers share one writer:

* **live export** (``buffer.export=True``): ``CheckpointCallback`` calls
  :func:`checkpoint_export` after every coupled checkpoint save.  The loop
  pays the row copies of the not-yet-exported window (the device ring's
  rows come off the card here, once); shard serialization, content digests
  and the ``dataset_export`` journal event ride the resilience async writer's
  thread when one is armed;
* **run-dir converter** (``python -m sheeprl_tpu_torch export <run dir>``,
  :func:`main`): the replay state of a finished (or crashed) run's newest
  *verified* checkpoint, the port's or the JAX package's, plus the run
  journal's identity and reward metadata;
* **direct API** (:func:`export_buffer`).

Stream mapping (see :mod:`sheeprl_tpu_torch.data.datasets`): step buffers
export one stream per environment (their per-env sub-buffers desync on
episode-end bookkeeping rows); ``EpisodeBuffer`` exports one stream per
stored episode, so episode boundaries are structural.  Incremental exports
keep cursors on the buffers' monotone ``added_steps`` counters: exporting
again is idempotent, and rows that fell out of the ring between exports
show as a gap between segments, which the loader never samples a sequence
across.
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.data.datasets import (
    discover_shards,
    write_dataset_meta,
    write_shard,
)

DEFAULT_SHARD_ROWS = 4096
#: The default dataset directory inside a run dir (next to `checkpoint/`).
DATASET_DIRNAME = "dataset"


# ---------------------------------------------------------------------------
# small buffer helpers (every buffer class of sheeprl_tpu_torch.data)


def flush_buffer(rb: Any) -> None:
    """Flush memmap-backed storage to disk before an export reads it (the
    host buffers' ``flush()``; the device ring has none)."""
    flush = getattr(rb, "flush", None)
    if callable(flush):
        flush()


def note_dataset_bytes(rb: Any, n_bytes: int) -> None:
    """Accumulate exported-dataset disk bytes on the buffer so
    ``footprint()`` reports them under the ``dataset_disk`` key (tracked per
    metric interval via ``diag.track_buffer``)."""
    try:
        rb.dataset_disk_bytes = int(getattr(rb, "dataset_disk_bytes", 0) or 0) + int(n_bytes)
    except Exception:  # pragma: no cover - exotic buffer doubles
        pass


# ---------------------------------------------------------------------------
# writer


class DatasetWriter:
    """Cursor-tracking shard writer for one dataset directory.

    Cursors (per-stream high-water marks) are recovered from the on-disk
    shard manifests at construction and *reserved* synchronously by
    :meth:`reserve`, so a caller may copy rows on the critical path and
    serialize them later on a background thread without a second export
    racing into the same range.
    """

    def __init__(
        self,
        root: str,
        meta: Optional[Mapping[str, Any]] = None,
        shard_rows: int = DEFAULT_SHARD_ROWS,
    ):
        self.root = str(root)
        self.shard_rows = max(1, int(shard_rows))
        write_dataset_meta(self.root, meta)
        shards, _ = discover_shards(self.root, deep=False)
        self._cursor: Dict[int, int] = {}
        for entry in shards:
            stream = int(entry["stream"])
            self._cursor[stream] = max(self._cursor.get(stream, 0), int(entry["stop"]))
        self.rows_written = 0
        self.bytes_written = 0
        self.shards_written = 0

    def cursor(self, stream: int) -> Optional[int]:
        """Steps of ``stream`` already exported (None = stream untouched)."""
        return self._cursor.get(int(stream))

    def reserve(self, stream: int, start: int, rows: int) -> Tuple[int, int]:
        """Claim ``[start, start+rows)`` of ``stream``; returns the effective
        ``(start, rows)`` after trimming the already-exported overlap (rows
        may be 0).  The cursor advances NOW — writes may happen later."""
        stream, start, rows = int(stream), int(start), int(rows)
        cur = self._cursor.get(stream)
        if cur is not None and start < cur:
            trim = min(rows, cur - start)
            start += trim
            rows -= trim
        if rows > 0:
            self._cursor[stream] = start + rows
        return start, rows

    def write(self, stream: int, start: int, arrays: Mapping[str, np.ndarray]) -> Dict[str, Any]:
        """Serialize one reserved chunk as ``shard_rows``-sized shards.
        Returns ``{rows, bytes, shards}``."""
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        n_rows = next(iter(arrays.values())).shape[0]
        out = {"rows": 0, "bytes": 0, "shards": 0}
        for off in range(0, n_rows, self.shard_rows):
            chunk = {k: v[off : off + self.shard_rows] for k, v in arrays.items()}
            entry = write_shard(self.root, stream, int(start) + off, chunk)
            out["rows"] += entry["rows"]
            out["bytes"] += entry["bytes"]
            out["shards"] += 1
        self.rows_written += out["rows"]
        self.bytes_written += out["bytes"]
        self.shards_written += out["shards"]
        return out


# ---------------------------------------------------------------------------
# chunk collection: (stream, start, arrays) copies of the unexported window


def _replay_chunks(rb: Any, writer: DatasetWriter, stream_base: int = 0) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
    """Unexported window of a (possibly wrapped) ``ReplayBuffer``: one chunk
    per env stream, rows in logical stream order."""
    if rb.empty:
        return []
    size = rb.buffer_size
    added = int(getattr(rb, "added_steps", 0) or 0)
    if added <= 0:
        # restored buffers predating the counter: fall back to the stored span
        added = size if rb.full else int(rb._pos)
    window_start = max(0, added - size)
    chunks: List[Tuple[int, int, Dict[str, np.ndarray]]] = []
    for env in range(rb.n_envs):
        stream = stream_base + env
        start, rows = writer.reserve(stream, window_start, added - window_start)
        if rows <= 0:
            continue
        slots = (np.arange(start, start + rows, dtype=np.int64)) % size
        arrays = {k: np.take(np.asarray(v), slots, axis=0)[:, env] for k, v in rb.buffer.items()}
        chunks.append((stream, start, arrays))
    return chunks


def _episode_chunks(rb: Any, writer: DatasetWriter) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
    """One stream per stored episode (monotone episode ids — evicted
    episodes never reuse a stream)."""
    chunks: List[Tuple[int, int, Dict[str, np.ndarray]]] = []
    ids = list(getattr(rb, "episode_ids", range(len(rb.buffer))))
    for eid, episode in zip(ids, rb.buffer):
        ep_len = next(iter(episode.values())).shape[0]
        start, rows = writer.reserve(int(eid), 0, ep_len)
        if rows <= 0:
            continue
        chunks.append((int(eid), start, {k: np.asarray(v)[start : start + rows].copy() for k, v in episode.items()}))
    return chunks


def _device_chunks(rb: Any, writer: DatasetWriter) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
    """The ring on the card: one host snapshot (its ``state_dict``, the
    storage copied off the device), then per-env logical windows from the
    per-env ``added_steps`` counters."""
    state = rb.state_dict()
    storage = {k: np.asarray(v) for k, v in state["buffer"].items()}
    size = rb.buffer_size
    added = np.asarray(getattr(rb, "added_steps", state.get("filled")), dtype=np.int64)
    filled = np.asarray(state["filled"], dtype=np.int64)
    chunks: List[Tuple[int, int, Dict[str, np.ndarray]]] = []
    for env in range(rb.n_envs):
        # clamped: buffers restored from pre-export checkpoints fall back to
        # added == filled, and a negative logical start must never escape
        # into shard names
        window_start = max(0, int(added[env] - min(filled[env], size)))
        start, rows = writer.reserve(env, window_start, int(added[env]) - window_start)
        if rows <= 0:
            continue
        slots = np.arange(start, start + rows, dtype=np.int64) % size
        chunks.append((env, start, {k: v[slots, env] for k, v in storage.items()}))
    return chunks


def collect_buffer_chunks(rb: Any, writer: DatasetWriter) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
    """Copy-on-the-caller-thread export chunks for any buffer class (the
    ranges are reserved in ``writer`` as a side effect)."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer, ReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer

    flush_buffer(rb)
    if isinstance(rb, EpisodeBuffer):
        return _episode_chunks(rb, writer)
    if isinstance(rb, EnvIndependentReplayBuffer):
        chunks: List[Tuple[int, int, Dict[str, np.ndarray]]] = []
        for env, sub in enumerate(rb.buffer):
            for _, start, arrays in _replay_chunks(sub, _SubWriter(writer, env)):
                chunks.append((env, start, arrays))
        return chunks
    if isinstance(rb, ReplayBuffer):
        return _replay_chunks(rb, writer)
    if isinstance(rb, DeviceSequentialReplayBuffer):
        return _device_chunks(rb, writer)
    raise TypeError(f"Unsupported replay buffer type for dataset export: {type(rb).__name__}")


class _SubWriter:
    """Redirect a sub-buffer's stream-0 reservation onto the parent stream
    (``EnvIndependentReplayBuffer`` sub-buffers are n_envs=1 rings)."""

    def __init__(self, writer: DatasetWriter, stream: int):
        self._writer = writer
        self._stream = int(stream)

    def reserve(self, _stream: int, start: int, rows: int) -> Tuple[int, int]:
        return self._writer.reserve(self._stream, start, rows)


# ---------------------------------------------------------------------------
# the three producers


class BufferDatasetExporter:
    """Persistent incremental exporter for one (buffer, dataset dir) pair —
    the object behind ``buffer.export=True``.

    ``export`` copies the unexported rows synchronously (reserving their
    ranges) and serializes them either inline or on ``submit`` (the
    resilience async-writer's task lane).  ``journal_fn`` receives one
    ``dataset_export`` event per export that wrote rows.
    """

    def __init__(
        self,
        root: str,
        meta: Optional[Mapping[str, Any]] = None,
        shard_rows: int = DEFAULT_SHARD_ROWS,
        journal_fn: Optional[Callable[..., None]] = None,
    ):
        self.writer = DatasetWriter(root, meta=meta, shard_rows=shard_rows)
        self._journal_fn = journal_fn

    def _journal(self, kind: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(kind, **fields)

    def export(
        self,
        rb: Any,
        step: Optional[int] = None,
        submit: Optional[Callable[[Callable[[], None]], Any]] = None,
    ) -> int:
        """Returns the rows queued/written by this call (0 = up to date)."""
        chunks = collect_buffer_chunks(rb, self.writer)
        pending = sum(arrays[next(iter(arrays))].shape[0] for _, _, arrays in chunks)
        if pending == 0:
            return 0

        def work() -> None:
            totals = {"rows": 0, "bytes": 0, "shards": 0}
            for stream, start, arrays in chunks:
                out = self.writer.write(stream, start, arrays)
                for key in totals:
                    totals[key] += out[key]
            note_dataset_bytes(rb, totals["bytes"])
            self._journal(
                "dataset_export",
                path=self.writer.root,
                step=step,
                **totals,
                total_rows=self.writer.rows_written,
                total_bytes=self.writer.bytes_written,
            )

        if submit is not None:
            submit(work)
        else:
            work()
        return pending


def export_buffer(
    rb: Any,
    root: str,
    meta: Optional[Mapping[str, Any]] = None,
    shard_rows: int = DEFAULT_SHARD_ROWS,
    journal_fn: Optional[Callable[..., None]] = None,
    step: Optional[int] = None,
) -> Dict[str, Any]:
    """One-shot synchronous export of a live buffer; returns the writer
    totals ``{rows, bytes, shards, path}``."""
    exporter = BufferDatasetExporter(root, meta=meta, shard_rows=shard_rows, journal_fn=journal_fn)
    exporter.export(rb, step=step)
    writer = exporter.writer
    return {
        "path": writer.root,
        "rows": writer.rows_written,
        "bytes": writer.bytes_written,
        "shards": writer.shards_written,
    }


def checkpoint_export(callback: Any, runtime: Any, ckpt_path: str, rb: Any) -> None:
    """The ``buffer.export=True`` checkpoint-boundary hook (called by
    ``CheckpointCallback.on_checkpoint_coupled`` right after the checkpoint
    save).  Copies ride the caller; serialization rides the resilience
    async-writer thread when the run has one."""
    from sheeprl_tpu_torch.resilience.manifest import checkpoint_step

    log_dir = str(Path(str(ckpt_path)).parent.parent)
    root = os.path.join(log_dir, DATASET_DIRNAME)
    diagnostics = getattr(runtime, "diagnostics", None)
    journal_fn = None
    submit = None
    if diagnostics is not None:
        journal_fn = diagnostics._journal_event
        resilience = getattr(diagnostics, "resilience", None)
        writer = getattr(resilience, "_writer", None) if resilience is not None else None
        if writer is not None and hasattr(writer, "submit_task"):
            submit = writer.submit_task
    exporter = getattr(callback, "_dataset_exporter", None)
    if exporter is None or exporter.writer.root != root:
        cfg = getattr(diagnostics, "_cfg", None) if diagnostics is not None else None
        meta = {"source": log_dir, "kind": "live_export"}
        if isinstance(cfg, Mapping):
            meta.update(_meta_from_cfg(cfg))
        exporter = BufferDatasetExporter(root, meta=meta, journal_fn=journal_fn)
        callback._dataset_exporter = exporter
    exporter._journal_fn = journal_fn  # late-opened journals attach here
    exporter.export(rb, step=checkpoint_step(str(ckpt_path)), submit=submit)


# ---------------------------------------------------------------------------
# run-dir converter


def _meta_from_cfg(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    algo = cfg.get("algo") or {}
    env = cfg.get("env") or {}
    mlp = (algo.get("mlp_keys") or {}).get("encoder")
    cnn = (algo.get("cnn_keys") or {}).get("encoder")
    return {
        "algo": algo.get("name"),
        "env_id": env.get("id"),
        "num_envs": env.get("num_envs"),
        "seed": cfg.get("seed"),
        "mlp_keys": list(mlp) if mlp else None,
        "cnn_keys": list(cnn) if cnn else None,
    }


def dataset_meta_from_run(run_dir: str) -> Dict[str, Any]:
    """Per-run dataset metadata: the archived config + the run journal's
    identity and reward summary (the journal is the durable record — it
    survives every crash the checkpoint survives)."""
    import yaml

    meta: Dict[str, Any] = {"source": str(run_dir), "kind": "run_dir_convert"}
    cfg_path = None
    for candidate in (Path(run_dir) / "config.yaml", *sorted(Path(run_dir).glob("*/config.yaml"))):
        if candidate.is_file():
            cfg_path = candidate
            break
    if cfg_path is not None:
        try:
            with open(cfg_path) as fp:
                meta.update(_meta_from_cfg(yaml.safe_load(fp) or {}))
        except Exception as err:  # pragma: no cover - corrupt archives
            warnings.warn(f"could not read archived config '{cfg_path}': {err!r}")
    from sheeprl_tpu_torch.diagnostics.journal import find_journal, iter_journal

    journal = find_journal(str(run_dir))
    if journal is not None:
        rewards: List[float] = []
        last_step = None
        for event in iter_journal(journal):
            kind = event.get("event")
            if kind == "run_start":
                meta.setdefault("run_id", event.get("run_id"))
                meta.setdefault("config_hash", event.get("config_hash"))
                meta.setdefault("algo", event.get("algo"))
                meta.setdefault("env_id", event.get("env"))
                meta.setdefault("seed", event.get("seed"))
            elif kind == "metrics":
                step = event.get("step")
                if isinstance(step, (int, float)):
                    last_step = int(step)
                reward = (event.get("metrics") or {}).get("Rewards/rew_avg")
                if isinstance(reward, (int, float)):
                    rewards.append(float(reward))
        meta["journal"] = {
            "path": journal,
            "last_step": last_step,
            "episodes_logged": len(rewards),
            "reward_mean": round(float(np.mean(rewards)), 6) if rewards else None,
            "reward_min": round(float(np.min(rewards)), 6) if rewards else None,
            "reward_max": round(float(np.max(rewards)), 6) if rewards else None,
        }
    return meta


def _rb_state_chunks(state: Mapping[str, Any]) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
    """Streams from a checkpointed replay-buffer ``state_dict`` (every
    buffer class's format).  Logical step numbering restarts at 0 — the
    converter has no monotone add counter, only the stored window."""
    chunks: List[Tuple[int, int, Dict[str, np.ndarray]]] = []
    if "buffers" in state:  # EnvIndependentReplayBuffer
        for env, sub in enumerate(state["buffers"]):
            for _, start, arrays in _rb_state_chunks(sub):
                chunks.append((env, start, arrays))
        return chunks
    buffer = state.get("buffer")
    if isinstance(buffer, list):  # EpisodeBuffer: one stream per episode
        for eid, episode in enumerate(buffer):
            arrays = {k: np.asarray(v) for k, v in episode.items()}
            if arrays and next(iter(arrays.values())).shape[0] > 0:
                chunks.append((eid, 0, arrays))
        return chunks
    if not isinstance(buffer, Mapping) or not buffer:
        return chunks
    storage = {k: np.asarray(v) for k, v in buffer.items()}
    size = next(iter(storage.values())).shape[0]
    n_envs = next(iter(storage.values())).shape[1]
    if "filled" in state:  # DeviceSequentialReplayBuffer host snapshot
        pos = np.asarray(state["pos"], dtype=np.int64)
        filled = np.asarray(state["filled"], dtype=np.int64)
        for env in range(n_envs):
            rows = int(min(filled[env], size))
            if rows <= 0:
                continue
            first = (pos[env] - rows) % size
            slots = (first + np.arange(rows, dtype=np.int64)) % size
            chunks.append((env, 0, {k: v[slots, env] for k, v in storage.items()}))
        return chunks
    # plain ReplayBuffer / SequentialReplayBuffer
    full = bool(state.get("full"))
    pos = int(state.get("pos", 0))
    rows = size if full else pos
    if rows <= 0:
        return chunks
    first = pos % size if full else 0
    slots = (first + np.arange(rows, dtype=np.int64)) % size
    for env in range(n_envs):
        chunks.append((env, 0, {k: v[slots, env] for k, v in storage.items()}))
    return chunks


def export_run_dir(
    run_dir: str,
    out_dir: Optional[str] = None,
    shard_rows: int = DEFAULT_SHARD_ROWS,
    journal_fn: Optional[Callable[..., None]] = None,
) -> Dict[str, Any]:
    """Convert an existing run dir into a dataset: the replay state of its
    newest manifest-verified checkpoint (``buffer.checkpoint=True`` runs;
    the port's checkpoints and the JAX package's) + journal metadata.

    Returns the writer totals; raises when the run has no verifiable
    checkpoint or its checkpoints carry no replay state.
    """
    from sheeprl_tpu_torch.resilience.manifest import checkpoint_step, newest_verified_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    best, skipped = newest_verified_checkpoint(str(run_dir), deep=True)
    if best is None:
        raise FileNotFoundError(
            f"No verifiable checkpoint under '{run_dir}' "
            f"({len(skipped)} rejected: {[s['reason'] for s in skipped[:5]]})"
        )
    state = load_state(best)
    rb_state = state.get("rb")
    if rb_state is None:
        raise ValueError(
            f"Checkpoint '{best}' carries no replay state ('rb'): the run was collected with "
            "buffer.checkpoint=False — re-collect with it on, or export live with buffer.export=True"
        )
    root = str(out_dir) if out_dir else os.path.join(str(run_dir), DATASET_DIRNAME)
    meta = dataset_meta_from_run(run_dir)
    meta["checkpoint"] = {"path": best, "step": checkpoint_step(best, state)}
    writer = DatasetWriter(root, meta=meta, shard_rows=shard_rows)
    for stream, start, arrays in _rb_state_chunks(rb_state):
        start, rows = writer.reserve(stream, start, next(iter(arrays.values())).shape[0])
        if rows <= 0:
            continue
        writer.write(stream, start, {k: v[-rows:] for k, v in arrays.items()})
    out = {
        "path": writer.root,
        "rows": writer.rows_written,
        "bytes": writer.bytes_written,
        "shards": writer.shards_written,
        "checkpoint": best,
    }
    if journal_fn is not None:
        journal_fn("dataset_export", step=meta["checkpoint"]["step"], **out)
    return out


# ---------------------------------------------------------------------------
# CLI (`python -m sheeprl_tpu_torch export <run dir>`)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Export a run's replay experience as a durable sharded dataset."
    )
    parser.add_argument("run_dir", help="run directory (or any ancestor of its checkpoints)")
    parser.add_argument(
        "--out", default=None, help=f"dataset directory (default: <run_dir>/{DATASET_DIRNAME})"
    )
    parser.add_argument(
        "--shard-rows", type=int, default=DEFAULT_SHARD_ROWS, help="max steps per shard file"
    )
    args = parser.parse_args(argv)
    try:
        out = export_run_dir(args.run_dir, out_dir=args.out, shard_rows=args.shard_rows)
    except (FileNotFoundError, ValueError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    print(
        f"exported {out['rows']} steps in {out['shards']} shard(s) "
        f"({out['bytes']} bytes) from {out['checkpoint']}\n -> {out['path']}"
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
