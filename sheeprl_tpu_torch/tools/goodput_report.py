"""Segment-aware post-mortem goodput accounting for (possibly resumed) runs.

The port's counterpart of ``tools/goodput_report.py``: the same arguments and,
from the same run, the same output; it imports neither torch nor JAX, so it
reads a run wherever the run's files are.

A preempted-and-resumed production run leaves one ``version_N`` checkpoint
dir per *segment* under the same run dir — each with its own crash-safe
journal.  This tool groups those siblings into ONE logical run and reports:

* per-segment wall / productive (train) / stalled time, last step, stall and
  profile-capture counts, and a status column — ``completed`` / ``halted`` /
  ``aborted`` from ``run_end``, **KILLED** when the journal ends without one
  (the newest segment is labeled ``live?`` instead while its journal is
  still fresh, since a running segment also has no ``run_end`` yet);
* productive time *recovered* from killed segments: their closing
  ``telemetry_summary`` never landed, so the last journaled cumulative
  ``Telemetry/goodput`` gauge reconstructs it (gauge × seconds since
  ``run_start``);
* time-to-recover between consecutive segments (end of the killed journal →
  first event of the resumed one) — ROADMAP item 4's headline number;
* whole-run totals: wall (first event → last event across segments, i.e.
  including the recovery gaps), productive, stalled, and overall goodput;
* when the run was driven by ``tools/supervise.py``, the supervisor's own
  ``<run dir>/supervisor.jsonl`` restart journal: restart count and the
  *measured* child-exit→respawn downtime per kill/resume cycle — real
  numbers, not inferred from segment gaps.

Usage:
    python -m sheeprl_tpu_torch.tools.goodput_report logs/runs/ppo/CartPole-v1/<run_name>/
    python -m sheeprl_tpu_torch.tools.goodput_report <run dir | journal.jsonl> [more...] --json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.diagnostics.goodput import segment_stats
from sheeprl_tpu_torch.diagnostics.journal import collect_journals, read_journal
from sheeprl_tpu_torch.diagnostics.report import goodput_status_lines

_VERSION_RE = re.compile(r"^version_(\d+)$")

SUPERVISOR_JOURNAL = "supervisor.jsonl"


def read_supervisor(run_dir: str) -> Optional[Dict[str, Any]]:
    """Restart accounting from the supervisor's own journal (None when the
    run was not supervised).  ``measured_down_s`` sums the supervisor's
    child-exit→respawn gaps — the directly measured half of time-to-recover
    (the resumed child's setup/compile time shows up in the segment gaps)."""
    path = os.path.join(run_dir, SUPERVISOR_JOURNAL)
    if not os.path.isfile(path):
        return None
    events = read_journal(path)
    restarts = [e for e in events if e.get("event") == "restart" and not e.get("gave_up")]
    gave_up = any(e.get("gave_up") for e in events if e.get("event") == "restart")
    downs = [e.get("down_s") for e in restarts if isinstance(e.get("down_s"), (int, float))]
    return {
        "restarts": len(restarts),
        "gave_up": gave_up,
        "measured_down_s": round(sum(downs), 3) if downs else None,
        "preempted_restarts": sum(1 for e in restarts if e.get("preempted")),
        "events": [
            {k: e.get(k) for k in ("t", "attempt", "rc", "preempted", "backoff_s", "down_s", "resume_from")}
            for e in restarts
        ],
    }

#: A run_end-less journal younger than this is "probably still running" —
#: applied to the NEWEST segment only; an older run_end-less segment is
#: definitionally dead (something resumed past it), so it is always KILLED.
LIVE_FRESHNESS_S = 120.0


def group_segment_journals(journal_paths: List[str]) -> List[Tuple[str, List[str]]]:
    """Group journal files into logical runs ``(run_dir, [segment journals])``.

    ONLY a ``version_N`` parent dir makes a journal a segment of the run dir
    above it — any other layout is one standalone run per journal (two
    unrelated sibling runs must never merge into a phantom resumed run).
    Segments sort by version number; standalone runs keep their own path as
    the group key.
    """
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for path in journal_paths:
        parent = os.path.dirname(os.path.abspath(path))
        match = _VERSION_RE.match(os.path.basename(parent))
        if match:
            run_dir = os.path.dirname(parent)
            groups.setdefault(run_dir, []).append((int(match.group(1)), path))
        else:
            # keyed by the journal's OWN path: two non-version_N journals
            # sharing a parent dir are unrelated runs, never segments
            groups.setdefault(os.path.abspath(path), []).append((0, path))
    out: List[Tuple[str, List[str]]] = []
    for run_dir in sorted(groups):
        segments = [p for _, p in sorted(groups[run_dir])]
        out.append((run_dir, segments))
    return out


def analyze_segments(
    journal_paths: List[str],
    now: Optional[float] = None,
    newest_events: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Stats for one logical run's ordered segment journals.

    ``newest_events`` (an output parameter: pass a list to be filled) hands
    the caller the newest segment's parsed events so ``format_run`` does not
    re-read a journal this function just parsed.
    """
    now = time.time() if now is None else now
    segments: List[Dict[str, Any]] = []
    for i, path in enumerate(journal_paths):
        events = read_journal(path)
        if newest_events is not None and i == len(journal_paths) - 1:
            newest_events[:] = events
        stats = segment_stats(events)
        stats["journal_path"] = path
        stats["segment"] = os.path.basename(os.path.dirname(os.path.abspath(path)))
        newest = i == len(journal_paths) - 1
        if stats["status"] is not None:
            stats["label"] = stats["status"]
        elif newest and stats["end_t"] is not None and now - stats["end_t"] < LIVE_FRESHNESS_S:
            stats["label"] = "live?"
        else:
            stats["label"] = "KILLED"
        segments.append(stats)

    gaps: List[Dict[str, Any]] = []
    for i in range(1, len(segments)):
        prev, cur = segments[i - 1], segments[i]
        if prev.get("end_t") is not None and cur.get("start_t") is not None:
            gaps.append(
                {
                    # enumerate-based labels: segments may repeat basenames
                    # across standalone-journal groups
                    "from": prev["segment"],
                    "to": cur["segment"],
                    "time_to_recover_s": round(max(0.0, cur["start_t"] - prev["end_t"]), 3),
                }
            )

    starts = [s["start_t"] for s in segments if s.get("start_t") is not None]
    ends = [s["end_t"] for s in segments if s.get("end_t") is not None]
    wall_s = round(max(ends) - min(starts), 3) if starts and ends else 0.0
    train_s = round(sum(s["train_s"] or 0.0 for s in segments), 3)
    recovered_s = round(
        sum(s["train_s"] or 0.0 for s in segments if s["label"] == "KILLED"), 3
    )
    stalled_s = round(sum(s["stalled_s"] or 0.0 for s in segments), 3)
    return {
        "segments": segments,
        "gaps": gaps,
        "wall_s": wall_s,
        "train_s": train_s,
        "recovered_train_s": recovered_s,
        "stalled_s": stalled_s,
        "goodput": round(train_s / wall_s, 4) if wall_s > 0 else None,
        "time_to_recover_s": round(sum(g["time_to_recover_s"] for g in gaps), 3) if gaps else None,
    }


def format_run(
    run_dir: str,
    analysis: Dict[str, Any],
    newest_events: Optional[List[Dict[str, Any]]] = None,
) -> str:
    segments = analysis["segments"]
    lines = [f"run: {run_dir} ({len(segments)} segment{'s' if len(segments) != 1 else ''})"]
    header = (
        f"  {'segment':<14s} {'status':<10s} {'wall':>9s} {'productive':>11s} "
        f"{'stalled':>8s} {'stalls':>6s} {'last step':>10s}"
    )
    lines.append(header)
    lines.append("  " + "-" * (len(header) - 2))
    for seg in segments:
        train = "—"
        if seg["train_s"] is not None:
            train = f"{seg['train_s']:.1f}s"
            if seg["train_source"] == "gauge":
                train += "*"
        last_step = "—" if seg["last_step"] is None else str(seg["last_step"])
        lines.append(
            f"  {seg['segment']:<14s} {seg['label']:<10s} {seg['wall_s']:>8.1f}s {train:>11s} "
            f"{seg['stalled_s']:>7.1f}s {seg['stalls']:>6d} {last_step:>10s}"
        )
    if any(s["train_source"] == "gauge" for s in segments):
        lines.append("  (* recovered from the last journaled Telemetry/goodput gauge)")
    for gap in analysis["gaps"]:
        lines.append(
            f"  time-to-recover {gap['from']} -> {gap['to']}: {gap['time_to_recover_s']:.1f}s"
        )
    total = f"  whole-run: wall {analysis['wall_s']:.1f}s · productive {analysis['train_s']:.1f}s"
    if analysis["goodput"] is not None:
        total += f" · goodput {analysis['goodput']:.1%}"
    if analysis["stalled_s"]:
        total += f" · stalled {analysis['stalled_s']:.1f}s"
    if analysis["recovered_train_s"]:
        total += f" · {analysis['recovered_train_s']:.1f}s productive recovered from killed segments"
    lines.append(total)
    supervisor = analysis.get("supervisor")
    if supervisor:
        line = f"  supervisor: {supervisor['restarts']} restart(s)"
        if supervisor.get("preempted_restarts"):
            line += f" ({supervisor['preempted_restarts']} preempted)"
        if supervisor.get("measured_down_s") is not None:
            line += f" · measured downtime {supervisor['measured_down_s']:.1f}s (restart journal)"
        if supervisor.get("gave_up"):
            line += " · GAVE UP (restart budget exhausted)"
        lines.append(line)
    # the newest segment's status panel, banner suppressed: this is a
    # post-mortem view, not a live dashboard (run_monitor keeps the banner)
    newest = segments[-1] if segments else None
    if newest is not None:
        events = (
            newest_events
            if newest_events is not None
            else read_journal(newest["journal_path"])
        )
        lines.extend("  " + line for line in goodput_status_lines(events, live=False))
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="+", help="run dirs and/or journal.jsonl files")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    journals = collect_journals(args.paths)
    if not journals:
        print(f"error: no journal.jsonl found under {args.paths}", file=sys.stderr)
        return 2
    runs = group_segment_journals(journals)
    if args.json:
        out = {}
        for run_dir, paths in runs:
            analysis = analyze_segments(paths)
            if os.path.isdir(run_dir):
                analysis["supervisor"] = read_supervisor(run_dir)
            out[run_dir] = analysis
        print(json.dumps(out, indent=2))
        return 0
    for i, (run_dir, paths) in enumerate(runs):
        if i:
            print()
        newest_events: List[Dict[str, Any]] = []
        analysis = analyze_segments(paths, newest_events=newest_events)
        if os.path.isdir(run_dir):
            analysis["supervisor"] = read_supervisor(run_dir)
        print(format_run(run_dir, analysis, newest_events=newest_events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
