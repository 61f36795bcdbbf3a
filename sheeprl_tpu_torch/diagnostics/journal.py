"""Crash-safe run journal (counterpart of
``sheeprl_tpu/diagnostics/journal.py``): a write-ahead JSONL event and
metric log.

Every aggregated metric interval, checkpoint, divergence finding and state
change is appended as one JSON object per line, flushed and fsync'd as it
is written, so a SIGKILL at any instant leaves at most one truncated
trailing line, which :func:`read_journal` skips.  One event per line:
``{"t": <unix time>, "event": "<kind>", ...}``; the kinds are
:data:`~sheeprl_tpu_torch.diagnostics.schema.EVENT_KINDS`, the JAX
package's, so its readers and report tools read a port run unchanged.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

JOURNAL_NAME = "journal.jsonl"


def _sanitize(value: Any) -> Any:
    """Make ``value`` strict-JSON serializable.

    Non-finite floats become the strings ``"nan"`` / ``"inf"`` / ``"-inf"``
    (``json.dumps`` would otherwise emit bare ``NaN`` tokens that strict
    parsers reject); numpy scalars/arrays collapse to Python scalars/lists.
    """
    if isinstance(value, dict):
        return {str(k): _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    if isinstance(value, bool) or value is None or isinstance(value, (int, str)):
        return value
    if isinstance(value, float):
        if math.isnan(value):
            return "nan"
        if math.isinf(value):
            return "inf" if value > 0 else "-inf"
        return value
    # numpy scalars / 0-d arrays / jax host scalars
    item = getattr(value, "item", None)
    if item is not None:
        try:
            return _sanitize(item())
        except Exception:
            pass
    tolist = getattr(value, "tolist", None)
    if tolist is not None:
        try:
            return _sanitize(tolist())
        except Exception:
            pass
    return str(value)


class RunJournal:
    """Append-only JSONL writer with per-event flush and fsync.

    ``fsync_every`` counts journal *events*: the facade writes one ``metrics``
    event per log interval, so the default of 1 is an fsync per log interval —
    a run's record survives a crash at the last interval — at a rate (one per
    ``metric.log_every`` policy steps) where fsync cost is irrelevant.
    """

    def __init__(self, path: str, fsync_every: int = 1):
        self.path = str(path)
        self._fsync_every = max(0, int(fsync_every))
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self._fp = open(self.path, "a", encoding="utf-8")
        self._count = 0
        self._closed = False
        # the loop thread is no longer the only writer: the stall watchdog
        # and the metrics-server HTTP threads journal concurrently, and an
        # interleaved fp.write would corrupt the line framing
        self._lock = threading.Lock()
        # wall-clock of the newest write: the /metrics endpoint exposes
        # now - last_write_t as sheeprl_journal_lag_seconds (stall detector)
        self.last_write_t: Optional[float] = None

    def write(self, event: str, **fields: Any) -> None:
        record: Dict[str, Any] = {"t": round(time.time(), 3), "event": str(event)}
        record.update(_sanitize(fields))
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with self._lock:
            if self._closed:
                return
            self.last_write_t = time.time()
            self._fp.write(line)
            self._fp.flush()
            self._count += 1
            if self._fsync_every and self._count % self._fsync_every == 0:
                try:
                    os.fsync(self._fp.fileno())
                except OSError:  # pragma: no cover - exotic filesystems
                    pass

    def sync(self) -> None:
        """Force buffered events to disk regardless of the fsync cadence —
        the OOM-forensics and stall paths call this so the post-mortem record
        survives the process dying immediately afterwards."""
        with self._lock:
            if self._closed:
                return
            try:
                self._fp.flush()
                os.fsync(self._fp.fileno())
            except (OSError, ValueError):  # pragma: no cover
                pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._fp.flush()
                os.fsync(self._fp.fileno())
            except (OSError, ValueError):  # pragma: no cover
                pass
            self._fp.close()


def iter_journal(path: str) -> Iterator[Dict[str, Any]]:
    """Yield events from a journal, tolerating a crash-truncated tail.

    A SIGKILL can only leave a partial *last* line (writes are line-buffered
    and flushed whole); a decode error there is silently skipped.  A decode
    error mid-file means external corruption — that line is skipped too, so
    one bad sector never makes the rest of the history unreadable.
    """
    with open(path, encoding="utf-8") as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(event, dict):
                yield event


def read_journal(path: str) -> List[Dict[str, Any]]:
    return list(iter_journal(path))


def find_journal(run_path: str) -> Optional[str]:
    """Locate a journal under a run directory (or pass a file through).

    Accepts the journal file itself, a ``version_N`` dir, or any ancestor run
    dir — the newest ``journal.jsonl`` below wins, matching how
    ``recover_reward_logs.py`` walks ``logs/runs/``.
    """
    if os.path.isfile(run_path):
        return run_path
    candidates = []
    for root, _, files in os.walk(run_path):
        if JOURNAL_NAME in files:
            candidates.append(os.path.join(root, JOURNAL_NAME))
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def collect_journals(paths: Sequence[str]) -> List[str]:
    """Expand files/run dirs into ALL journal files below them (sorted,
    de-duplicated) — unlike :func:`find_journal`, every segment of a resumed
    run is kept: ``tools/goodput_report.py`` groups the ``version_N``
    siblings into one logical run, and ``tools/trace_report.py`` reads them
    for the run-state overlay."""
    out: List[str] = []
    for path in paths:
        # normalized so the same journal reached via different spellings
        # (explicit file arg vs. a dir walk) de-duplicates to one entry
        if os.path.isfile(path):
            out.append(os.path.abspath(path))
        elif os.path.isdir(path):
            for root, _, files in os.walk(path):
                if JOURNAL_NAME in files:
                    out.append(os.path.abspath(os.path.join(root, JOURNAL_NAME)))
    seen, unique = set(), []
    for path in sorted(out):
        if path not in seen:
            seen.add(path)
            unique.append(path)
    return unique
