"""Summarize or export a run-health journal (``journal.jsonl``).

The port's counterpart of ``tools/journal_report.py``: the same arguments and,
from the same run, the same output; it imports neither torch nor JAX, so it
reads a run wherever the run's files are.

The journal is the crash-safe record every training run writes next to its
checkpoints (see ``howto/diagnostics.md``): after a SIGKILL'd run this tool
reproduces the last logged metrics — including ``Rewards/rew_avg`` — and the
step counter without touching TensorBoard event files.

Usage:
    python -m sheeprl_tpu_torch.tools.journal_report logs/runs/ppo/CartPole-v1/<run>/
    python -m sheeprl_tpu_torch.tools.journal_report path/to/journal.jsonl --csv rewards.csv
    python -m sheeprl_tpu_torch.tools.journal_report <run dir> --json        # machine-readable
    python -m sheeprl_tpu_torch.tools.journal_report <run dir> --follow      # live tail

Accepts a journal file, a ``version_N`` directory, or any run-dir ancestor
(the newest journal below wins — for ALL segments of a resumed run, use
``sheeprl_tpu_torch.tools.goodput_report``, which groups the ``version_N`` siblings with
killed-segment detection and time-to-recover).  ``--follow`` streams every
journal row — including the live ``Telemetry/*`` gauges, the
``state_change``/``stall`` run-lifecycle events and the learning-health
``anomaly``/``anomaly_end`` events (rendered as an ``!! ANOMALY`` line) — as
the compact one-line format shared with ``tools/run_monitor.py``, until the
run ends or Ctrl-C (``sheeprl_tpu_torch.tools.health_report`` renders the full learn-health
post-mortem).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Iterator, Optional, Sequence

from sheeprl_tpu_torch.diagnostics.journal import find_journal
from sheeprl_tpu_torch.diagnostics.report import format_event_line, format_summary, summarize, to_csv


def tail_journal(path: str, poll_s: float = 0.5, follow: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield journal events as they land (byte-offset tail; a partial trailing
    line is left in the buffer until its newline arrives)."""
    offset = 0
    buffer = ""
    while True:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size < offset:  # truncated/rotated from under us: start over
            offset, buffer = 0, ""
        if size > offset:
            with open(path, encoding="utf-8") as fp:
                fp.seek(offset)
                chunk = fp.read()
                offset = fp.tell()
            buffer += chunk
            while "\n" in buffer:
                line, buffer = buffer.split("\n", 1)
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(event, dict):
                    yield event
        elif not follow:
            return
        else:
            time.sleep(poll_s)
        if not follow and size <= offset and not buffer:
            return


def follow(path: str, interval: float) -> int:
    """Tail mode: replay the journal so far, then stream new rows."""
    journal_path = find_journal(path)
    if journal_path is None:
        print(f"error: no journal.jsonl found under '{path}'", file=sys.stderr)
        return 2
    print(f"journal: {journal_path}", flush=True)
    try:
        for event in tail_journal(journal_path, poll_s=interval, follow=True):
            print(format_event_line(event), flush=True)
            if event.get("event") == "run_end":
                return 0
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", help="journal.jsonl, a version_N dir, or a run dir")
    parser.add_argument("--csv", metavar="OUT", help="export the metric history to OUT as CSV")
    parser.add_argument("--json", action="store_true", help="print the summary as JSON instead of text")
    parser.add_argument("--follow", "-f", action="store_true", help="tail mode: stream journal rows live")
    parser.add_argument("--interval", type=float, default=0.5, help="tail poll interval in seconds")
    args = parser.parse_args(argv)

    if args.follow:
        return follow(args.path, args.interval)

    try:
        summary = summarize(args.path)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(format_summary(summary))

    if args.csv:
        n = to_csv(args.path, args.csv)
        print(f"\nwrote {n} metric rows to {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
