"""Durable replay datasets: sharded experience on disk and a streaming
loader (counterpart of ``sheeprl_tpu/data/datasets.py``; the same layout,
manifests and batch draws, so a dataset either package writes opens in the
other and yields the same batches for the same seed).

Layout (one directory per dataset)::

    dataset/
      dataset.json                      # format version + free-form run meta
      shard-00000-0000000000.npz        # stream 0, logical steps [0, T0)
      shard-00000-0000000000.npz.manifest.json
      shard-00001-0000000000.npz        # stream 1, ...
      ...

A **stream** is one ordered sequence of transitions: one per environment for
the step buffers (their per-env sub-buffers desync on episode-end
bookkeeping rows, so streams cannot share a time axis), one per stored
episode for :class:`~sheeprl_tpu_torch.data.buffers.EpisodeBuffer`.  Every
shard holds a contiguous ``[T, ...]`` slice of its stream per key and a
manifest sidecar in the checkpoint manifests' pattern
(:mod:`sheeprl_tpu_torch.resilience.manifest`): content sha256 and byte
size, the logical step range, per-key shapes and dtypes and the code
fingerprint.  Opening a dataset verifies every shard and *skips* torn or
corrupt ones, as resume selection skips corrupt checkpoints: each skip is a
``dataset_shard_skipped`` record the caller journals, never a crash.

:class:`OfflineDataset` serves batches: deterministic seeded windowed
shuffles (the same seed gives the same batch sequence, prefetch on or off),
flat transition batches for the SAC family and contiguous ``[T, B, ...]``
sequence windows for the Dreamer family (inside one segment and, optionally,
one episode; ``rssm_*`` stored-state keys included), with an optional
background prefetch thread on the host.  The module is numpy only.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

DATASET_META_NAME = "dataset.json"
DATASET_FORMAT = 1
SHARD_MANIFEST_SUFFIX = ".manifest.json"

_SHARD_RE = re.compile(r"^shard-(\d+)-(\d+)\.npz$")


def shard_name(stream: int, start: int) -> str:
    return f"shard-{int(stream):05d}-{int(start):010d}.npz"


def shard_manifest_path(shard_path: str) -> str:
    return str(shard_path) + SHARD_MANIFEST_SUFFIX


def _code_fingerprint() -> str:
    """The writing code's stamp in a shard manifest (informational: a
    dataset is read across revisions and packages)."""
    try:
        from sheeprl_tpu_torch.resilience.manifest import code_fingerprint

        return code_fingerprint()
    except Exception:  # never block a write on this
        return "?"


def _key_spec(arrays: Mapping[str, np.ndarray]) -> Dict[str, List[Any]]:
    """``{key: [per-step shape, dtype]}`` — the manifest's structural record
    (the dataset-side analogue of ``resilience.manifest.tree_spec``)."""
    return {k: [list(v.shape[1:]), str(v.dtype)] for k, v in arrays.items()}


def write_shard(root: str, stream: int, start: int, arrays: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Write one ``[T, ...]``-per-key shard + manifest sidecar (both atomic
    tmp+rename; the shard lands first, so a crash can only leave a shard
    *without* a manifest — which open-time verification then skips, exactly
    like a legacy/torn checkpoint).  Returns the manifest entry."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    if not arrays:
        raise ValueError("cannot write an empty shard")
    rows = {k: v.shape[0] for k, v in arrays.items()}
    if len(set(rows.values())) != 1:
        raise ValueError(f"every shard key must agree on the time axis, got {rows}")
    n_rows = next(iter(rows.values()))
    if n_rows <= 0:
        raise ValueError("cannot write a zero-row shard")
    from sheeprl_tpu_torch.resilience.manifest import _file_digest

    os.makedirs(root, exist_ok=True)
    path = os.path.join(str(root), shard_name(stream, start))
    tmp = path + ".tmp"
    # savez appends ".npz" to plain string paths — hand it a file object so
    # the tmp name is exactly what os.replace sees
    with open(tmp, "wb") as fp:
        np.savez(fp, **arrays)
        fp.flush()
        try:
            os.fsync(fp.fileno())
        except OSError:  # pragma: no cover - exotic filesystems
            pass
    os.replace(tmp, path)
    entry: Dict[str, Any] = {
        "format": DATASET_FORMAT,
        "stream": int(stream),
        "start": int(start),
        "stop": int(start) + int(n_rows),
        "rows": int(n_rows),
        "bytes": os.path.getsize(path),
        "sha256": _file_digest(path),
        "keys": _key_spec(arrays),
        "fingerprint": _code_fingerprint(),
        "written_t": round(time.time(), 3),
    }
    man_path = shard_manifest_path(path)
    man_tmp = man_path + ".tmp"
    with open(man_tmp, "w", encoding="utf-8") as fp:
        json.dump(entry, fp)
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(man_tmp, man_path)
    return entry


def read_shard_manifest(shard_path: str) -> Optional[Dict[str, Any]]:
    path = shard_manifest_path(shard_path)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as fp:
            entry = json.load(fp)
        return entry if isinstance(entry, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def verify_shard(shard_path: str, deep: bool = True) -> Tuple[bool, str]:
    """``(ok, reason)`` for one shard file — the checkpoint verification
    contract (every failure mode is a reason string, never an exception):
    ``no_manifest`` (torn write), ``size_mismatch`` (truncated),
    ``digest_mismatch`` (corrupt, deep only), ``verified``."""
    shard_path = str(shard_path)
    if not os.path.isfile(shard_path):
        return False, "missing"
    size = os.path.getsize(shard_path)
    if size == 0:
        return False, "empty"
    entry = read_shard_manifest(shard_path)
    if entry is None:
        return False, "no_manifest"
    if entry.get("bytes") != size:
        return False, "size_mismatch"
    if deep:
        from sheeprl_tpu_torch.resilience.manifest import _file_digest

        if entry.get("sha256") != _file_digest(shard_path):
            return False, "digest_mismatch"
    return True, "verified"


def write_dataset_meta(root: str, meta: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Write (or merge-update) the dataset's top-level ``dataset.json``."""
    os.makedirs(str(root), exist_ok=True)
    path = os.path.join(str(root), DATASET_META_NAME)
    entry: Dict[str, Any] = {"format": DATASET_FORMAT, "created_t": round(time.time(), 3), "meta": {}}
    existing = read_dataset_meta(root)
    if existing is not None:
        entry.update(existing)
    if meta:
        merged = dict(entry.get("meta") or {})
        merged.update({k: v for k, v in meta.items() if v is not None})
        entry["meta"] = merged
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fp:
        json.dump(entry, fp, indent=1)
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, path)
    return entry


def read_dataset_meta(root: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(str(root), DATASET_META_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as fp:
            entry = json.load(fp)
        return entry if isinstance(entry, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def discover_shards(
    root: str, deep: bool = True
) -> Tuple[List[Dict[str, Any]], List[Dict[str, str]]]:
    """All verified shard manifests under ``root`` (sorted by stream then
    start) plus a ``{path, reason}`` skip record per rejected shard — the
    dataset-side ``newest_verified_checkpoint`` contract: torn/corrupt data
    is skipped and reported, never crashed on."""
    good: List[Dict[str, Any]] = []
    skipped: List[Dict[str, str]] = []
    p = Path(str(root))
    if not p.is_dir():
        return good, skipped
    for shard in sorted(p.iterdir()):
        match = _SHARD_RE.match(shard.name)
        if match is None:
            continue
        ok, reason = verify_shard(str(shard), deep=deep)
        if not ok:
            skipped.append({"path": str(shard), "reason": reason})
            continue
        entry = read_shard_manifest(str(shard))
        # trust the filename over a (verified but conceivably relocated)
        # manifest for stream/start identity
        entry["stream"] = int(match.group(1))
        entry["start"] = int(match.group(2))
        entry.setdefault("stop", entry["start"] + int(entry.get("rows", 0)))
        entry["path"] = str(shard)
        good.append(entry)
    good.sort(key=lambda e: (e["stream"], e["start"]))
    return good, skipped


class _Segment:
    """A contiguous run of verified shards within one stream: logical steps
    ``[start, stop)`` with no gaps (a skipped shard splits its stream into
    two segments — sequence windows never span the hole)."""

    __slots__ = ("stream", "start", "stop", "shards")

    def __init__(self, stream: int, start: int):
        self.stream = int(stream)
        self.start = int(start)
        self.stop = int(start)
        self.shards: List[Dict[str, Any]] = []

    @property
    def rows(self) -> int:
        return self.stop - self.start


class OfflineDataset:
    """Manifest-validated streaming view over an exported dataset.

    * shard discovery skips torn/corrupt shards (``self.skipped`` carries the
      records for the caller to journal as ``dataset_shard_skipped``);
    * :meth:`gather` / :meth:`gather_window` are the exact-index read path;
    * :meth:`batches` is the training feed: deterministic seeded windowed
      shuffle, flat or sequence mode, optional background prefetch thread
      (``prefetch=N`` keeps up to N host batches staged ahead; the batch
      *sequence* is identical with prefetch on or off).
    """

    def __init__(
        self,
        root: str,
        deep_verify: bool = True,
        cache_shards: int = 8,
    ):
        self.root = str(root)
        self.meta = read_dataset_meta(self.root) or {}
        shards, self.skipped = discover_shards(self.root, deep=deep_verify)
        if not shards:
            raise FileNotFoundError(
                f"No verifiable dataset shards under '{self.root}' "
                f"({len(self.skipped)} rejected: {[s['reason'] for s in self.skipped[:5]]})"
            )
        self.segments: List[_Segment] = []
        current: Optional[_Segment] = None
        for entry in shards:
            if current is None or entry["stream"] != current.stream or entry["start"] != current.stop:
                current = _Segment(entry["stream"], entry["start"])
                self.segments.append(current)
            current.shards.append(entry)
            current.stop = entry["stop"]
        self.keys: Tuple[str, ...] = tuple(shards[0].get("keys") or ())
        self.key_specs: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
            k: (tuple(spec[0]), np.dtype(spec[1])) for k, spec in (shards[0].get("keys") or {}).items()
        }
        self.streams: Tuple[int, ...] = tuple(sorted({s.stream for s in self.segments}))
        self._cache: "OrderedDict[str, Dict[str, np.ndarray]]" = OrderedDict()
        self._cache_shards = max(1, int(cache_shards))
        self._cache_lock = threading.Lock()

    # -- introspection ------------------------------------------------------
    @property
    def total_rows(self) -> int:
        return sum(seg.rows for seg in self.segments)

    @property
    def total_bytes(self) -> int:
        return sum(int(sh.get("bytes", 0)) for seg in self.segments for sh in seg.shards)

    @property
    def n_shards(self) -> int:
        return sum(len(seg.shards) for seg in self.segments)

    def summary(self) -> Dict[str, Any]:
        """The ``dataset_open`` journal payload."""
        return {
            "path": self.root,
            "streams": len(self.streams),
            "segments": len(self.segments),
            "shards": self.n_shards,
            "rows": self.total_rows,
            "bytes": self.total_bytes,
            "skipped": len(self.skipped),
            "keys": sorted(self.keys),
        }

    # -- raw read path ------------------------------------------------------
    def _load_shard(self, entry: Mapping[str, Any], keys: Sequence[str]) -> Dict[str, np.ndarray]:
        """Decode (only) ``keys`` of one shard, merging into the LRU cache —
        a metadata scan over done flags/rewards never decompresses the pixel
        arrays living in the same shards."""
        path = entry["path"]
        with self._cache_lock:
            cached = self._cache.get(path)
            if cached is not None and all(k in cached for k in keys):
                self._cache.move_to_end(path)
                return cached
        arrays = dict(cached or {})
        with np.load(path, allow_pickle=False) as payload:
            for k in keys:
                if k not in arrays:
                    arrays[k] = payload[k]
        with self._cache_lock:
            self._cache[path] = arrays
            self._cache.move_to_end(path)
            while len(self._cache) > self._cache_shards:
                self._cache.popitem(last=False)
        return arrays

    def _segment_rows(self, seg: _Segment, steps: np.ndarray, keys: Sequence[str]) -> Dict[str, np.ndarray]:
        """Gather arbitrary logical ``steps`` of one segment (grouped by
        owning shard, order preserved)."""
        out = {
            k: np.empty((len(steps), *self.key_specs[k][0]), self.key_specs[k][1]) for k in keys
        }
        starts = np.asarray([sh["start"] for sh in seg.shards])
        owner = np.searchsorted(starts, steps, side="right") - 1
        for shard_idx in np.unique(owner):
            entry = seg.shards[int(shard_idx)]
            mask = owner == shard_idx
            local = steps[mask] - entry["start"]
            arrays = self._load_shard(entry, keys)
            for k in keys:
                out[k][mask] = arrays[k][local]
        return out

    def _find_segment(self, stream: int, step: int) -> _Segment:
        for seg in self.segments:
            if seg.stream == stream and seg.start <= step < seg.stop:
                return seg
        raise IndexError(f"step {step} of stream {stream} is not covered by any verified shard")

    def gather(self, stream: int, steps: Sequence[int], keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """``{key: [N, ...]}`` for arbitrary logical steps of one stream."""
        keys = tuple(keys or self.keys)
        steps = np.asarray(steps, dtype=np.int64)
        out = {k: np.empty((len(steps), *self.key_specs[k][0]), self.key_specs[k][1]) for k in keys}
        seg_of = [self._find_segment(stream, int(s)) for s in steps]
        for seg in {id(s): s for s in seg_of}.values():
            mask = np.asarray([sg is seg for sg in seg_of])
            part = self._segment_rows(seg, steps[mask], keys)
            for k in keys:
                out[k][mask] = part[k]
        return out

    def gather_window(self, stream: int, start: int, length: int, keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """``{key: [length, ...]}`` contiguous window (must lie inside one
        segment — the episode/hole discipline sequence sampling enforces)."""
        seg = self._find_segment(stream, int(start))
        if int(start) + int(length) > seg.stop:
            raise IndexError(
                f"window [{start}, {start + length}) of stream {stream} crosses the end of its "
                f"contiguous segment [{seg.start}, {seg.stop})"
            )
        steps = np.arange(int(start), int(start) + int(length), dtype=np.int64)
        return self._segment_rows(seg, steps, tuple(keys or self.keys))

    # -- sampling index spaces ---------------------------------------------
    def _flat_index(self, need_next: bool) -> List[Tuple[_Segment, int, int]]:
        """(segment, first_step, n_valid) per segment for flat sampling;
        deriving next-obs from step+1 drops each segment's last row."""
        out = []
        for seg in self.segments:
            n = seg.rows - (1 if need_next else 0)
            if n > 0:
                out.append((seg, seg.start, n))
        return out

    def _sequence_index(
        self, sequence_length: int, respect_episodes: bool
    ) -> List[Tuple[_Segment, np.ndarray]]:
        """(segment, valid start steps) per segment for sequence sampling.

        A start is valid when the full window fits inside the segment;
        ``respect_episodes`` additionally rejects windows with an episode
        boundary strictly inside them (``is_first`` after position 0 when the
        dataset stores it, else a done row before the window's last step).
        """
        out = []
        T = int(sequence_length)
        for seg in self.segments:
            if seg.rows < T:
                continue
            starts = np.arange(seg.start, seg.stop - T + 1, dtype=np.int64)
            if respect_episodes and seg.rows > 0:
                boundary = self._episode_boundaries(seg)
                if boundary is not None:
                    # window [s, s+T) is valid iff no boundary in (s, s+T)
                    bad = np.zeros(len(starts), dtype=bool)
                    for b in np.nonzero(boundary)[0]:
                        step = seg.start + int(b)
                        lo = max(seg.start, step - T + 1)
                        bad[max(0, lo - seg.start) : max(0, step - seg.start)] = True
                    starts = starts[~bad]
            if len(starts):
                out.append((seg, starts))
        return out

    def _episode_boundaries(self, seg: _Segment) -> Optional[np.ndarray]:
        """Per-row bool: row STARTS a new episode (``is_first``) — derived
        from dones when the dataset predates ``is_first``."""
        if "is_first" in self.key_specs:
            rows = self.gather_window(seg.stream, seg.start, seg.rows, keys=("is_first",))
            return np.asarray(rows["is_first"]).reshape(seg.rows, -1).any(axis=-1)
        if "terminated" in self.key_specs or "truncated" in self.key_specs:
            keys = [k for k in ("terminated", "truncated") if k in self.key_specs]
            rows = self.gather_window(seg.stream, seg.start, seg.rows, keys=keys)
            done = np.zeros(seg.rows, dtype=bool)
            for k in keys:
                done |= np.asarray(rows[k]).reshape(seg.rows, -1).any(axis=-1)
            first = np.zeros(seg.rows, dtype=bool)
            first[1:] = done[:-1]
            return first
        return None

    # -- deterministic batch feed ------------------------------------------
    def batches(
        self,
        batch_size: int,
        *,
        seed: int,
        mode: str = "flat",
        sequence_length: int = 1,
        keys: Optional[Sequence[str]] = None,
        derive_next_obs: bool = False,
        next_obs_keys: Sequence[str] = ("observations",),
        respect_episodes: bool = False,
        shuffle_window: int = 1 << 16,
        prefetch: int = 0,
        on_epoch: Optional[Callable[[int], None]] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite deterministic batch iterator.

        ``mode="flat"`` yields ``{key: [B, ...]}`` transition batches
        (``derive_next_obs`` adds ``next_<k>`` for ``next_obs_keys`` from the
        stream successor row — the live ``sample_next_obs`` semantics);
        ``mode="sequence"`` yields ``{key: [T, B, ...]}`` contiguous windows
        (time-major, the Dreamer train-batch layout).

        Batch ``i`` for a given ``(seed, mode, batch_size, ...)`` is the same
        arrays no matter how the iterator is driven — the windowed shuffle is
        a pure function of ``(seed, epoch)`` and prefetching (``prefetch>0``)
        only moves WHERE batches are assembled, never their order.  Partial
        trailing batches are dropped (stable shapes);
        ``on_epoch(epoch)`` fires when a new epoch's permutation starts.
        """
        if batch_size <= 0:
            raise ValueError(f"'batch_size' must be > 0, got {batch_size}")
        if mode not in ("flat", "sequence"):
            raise ValueError(f"mode must be 'flat' or 'sequence', got {mode!r}")
        source = self._batch_source(
            batch_size,
            seed=int(seed),
            mode=mode,
            sequence_length=int(sequence_length),
            keys=tuple(keys or self.keys),
            derive_next_obs=bool(derive_next_obs),
            next_obs_keys=tuple(next_obs_keys),
            respect_episodes=bool(respect_episodes),
            shuffle_window=max(1, int(shuffle_window)),
            on_epoch=on_epoch,
        )
        if prefetch and int(prefetch) > 0:
            return _prefetch_iter(source, depth=int(prefetch))
        return source

    def _batch_source(
        self,
        batch_size: int,
        *,
        seed: int,
        mode: str,
        sequence_length: int,
        keys: Tuple[str, ...],
        derive_next_obs: bool,
        next_obs_keys: Tuple[str, ...],
        respect_episodes: bool,
        shuffle_window: int,
        on_epoch: Optional[Callable[[int], None]],
    ) -> Iterator[Dict[str, np.ndarray]]:
        if mode == "flat":
            index = self._flat_index(need_next=derive_next_obs)
            n_total = sum(n for _, _, n in index)
            if n_total < batch_size:
                raise ValueError(
                    f"dataset has only {n_total} usable transitions but the batch size is {batch_size}"
                )
            spans = np.cumsum([0] + [n for _, _, n in index])
        else:
            seq_index = self._sequence_index(sequence_length, respect_episodes)
            n_total = sum(len(starts) for _, starts in seq_index)
            if n_total < batch_size:
                raise ValueError(
                    f"dataset has only {n_total} valid length-{sequence_length} windows but the "
                    f"batch size is {batch_size}"
                )
            spans = np.cumsum([0] + [len(starts) for _, starts in seq_index])

        def assemble(flat_ids: np.ndarray) -> Dict[str, np.ndarray]:
            owner = np.searchsorted(spans, flat_ids, side="right") - 1
            if mode == "flat":
                out = {
                    k: np.empty((len(flat_ids), *self.key_specs[k][0]), self.key_specs[k][1])
                    for k in keys
                }
                if derive_next_obs:
                    for k in next_obs_keys:
                        out[f"next_{k}"] = np.empty(
                            (len(flat_ids), *self.key_specs[k][0]), self.key_specs[k][1]
                        )
                for seg_idx in np.unique(owner):
                    seg, first, _ = index[int(seg_idx)]
                    mask = owner == seg_idx
                    steps = first + (flat_ids[mask] - spans[seg_idx])
                    part = self._segment_rows(seg, steps, keys)
                    for k in keys:
                        out[k][mask] = part[k]
                    if derive_next_obs:
                        nxt = self._segment_rows(seg, steps + 1, next_obs_keys)
                        for k in next_obs_keys:
                            out[f"next_{k}"][mask] = nxt[k]
                return out
            out = {
                k: np.empty(
                    (sequence_length, len(flat_ids), *self.key_specs[k][0]), self.key_specs[k][1]
                )
                for k in keys
            }
            for seg_idx in np.unique(owner):
                seg, starts = seq_index[int(seg_idx)]
                for col in np.nonzero(owner == seg_idx)[0]:
                    start = int(starts[flat_ids[col] - spans[seg_idx]])
                    window = self._segment_rows(
                        seg, np.arange(start, start + sequence_length, dtype=np.int64), keys
                    )
                    for k in keys:
                        out[k][:, col] = window[k]
            return out

        epoch = 0
        while True:
            if on_epoch is not None:
                on_epoch(epoch)
            rng = np.random.default_rng([int(seed), int(epoch)])
            pending: List[np.ndarray] = []
            pending_n = 0
            for w0 in range(0, n_total, shuffle_window):
                window = np.arange(w0, min(w0 + shuffle_window, n_total), dtype=np.int64)
                rng.shuffle(window)
                pending.append(window)
                pending_n += len(window)
                while pending_n >= batch_size:
                    flat = np.concatenate(pending) if len(pending) > 1 else pending[0]
                    yield assemble(flat[:batch_size])
                    rest = flat[batch_size:]
                    pending = [rest] if len(rest) else []
                    pending_n = len(rest)
            epoch += 1  # partial tail dropped: stable batch shapes


def _prefetch_iter(source: Iterator[Dict[str, np.ndarray]], depth: int) -> Iterator[Dict[str, np.ndarray]]:
    """Background host-prefetch: a daemon thread drains ``source`` into a
    bounded queue so batch assembly (shard reads, gathers) overlaps the
    consumer's device step.  Order-preserving by construction — one producer,
    one FIFO — so prefetch-on streams the identical batch sequence."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    _END = object()

    def worker() -> None:
        try:
            for item in source:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as err:  # surface loader errors to the consumer
            try:
                q.put(err, timeout=5.0)
            except queue.Full:  # pragma: no cover - consumer gone
                pass

    thread = threading.Thread(target=worker, name="sheeprl-dataset-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
