"""Merge Chrome phase traces from multiple processes and report per-phase time.

The port's counterpart of ``tools/trace_report.py``: the same arguments and,
from the same run, the same output; it imports neither torch nor JAX, so it
reads a run wherever the run's files are.

Every trace the diagnostics tracer writes (``diagnostics.trace.enabled=True``)
opens with a ``clock_sync`` instant whose ``epoch_t0_us`` anchors that file's
monotonic ``ts`` values on the Unix epoch, and names the run id, rank and role
(player / trainer / main — or ``server`` for the serving tier's
``trace_serve.json``, whose per-request ``serve-*`` spans then line up against
training's phase spans on the same absolute clock: a training ``checkpoint``
span is followed by a ``ckpt_promote`` instant on the serving track, listed in
the report's instant-markers section).  This tool uses those anchors to:

* merge traces written by different processes — a decoupled player + trainer
  pair, or the per-rank ``trace_rank{N}.json`` files of a multihost run — into
  ONE Chrome/Perfetto-loadable timeline (``--out merged.json``),
* print the per-phase wall-clock table (count / total / mean / share per
  role) that PERF.md §3 used to hand-compute from isolated runs, and
* overlay the run-state machine (ISSUE 8) as its own track: when a *run dir*
  argument also contains a ``journal.jsonl``, its ``state_change`` /
  ``stall`` / ``stall_end`` events and per-interval ``Telemetry/run_state``
  gauges become state spans on the same absolute timeline (journal ``t`` is
  the same Unix clock the trace anchors use), so "the pool stalled HERE"
  lines up against the phase spans.  Stalled time is drawn from the
  ``stall``/``stall_end`` bounds only — exactly one span per stall — and the
  overlay never feeds the phase table.

Accepts trace files, run directories (all ``trace*.json`` below are taken,
rotated ``.1``/``.2`` generations included) and crash-truncated files (the
unterminated-array form a SIGKILL leaves).

Usage:
    python -m sheeprl_tpu_torch.tools.trace_report logs/runs/.../version_0/
    python -m sheeprl_tpu_torch.tools.trace_report player/trace.json trainer/trace.json --out merged.json
    python -m sheeprl_tpu_torch.tools.trace_report <run dir> --json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.diagnostics.goodput import STATES
from sheeprl_tpu_torch.diagnostics.journal import collect_journals, read_journal


def load_trace(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Load one trace file (complete or crash-truncated array).

    Returns ``(meta, events)`` where ``meta`` comes from the file's
    ``clock_sync`` anchor (``{run_id, rank, role, epoch_t0_us}``).
    """
    raw = open(path, encoding="utf-8").read().strip()
    if not raw:
        return {}, []
    if raw.endswith("]"):
        events = json.loads(raw)
    else:
        # SIGKILL'd writer: unterminated streaming array, possibly ending in a
        # half-serialized event — drop trailing lines until the array parses
        lines = raw.splitlines()
        events = []
        while lines:
            candidate = "\n".join(lines).rstrip().rstrip(",") + "\n]"
            try:
                events = json.loads(candidate)
                break
            except json.JSONDecodeError:
                lines.pop()
    meta: Dict[str, Any] = {}
    for event in events:
        if event.get("name") == "clock_sync":
            meta = dict(event.get("args") or {})
            break
    return meta, events


def collect_trace_files(paths: List[str]) -> List[str]:
    """Expand run dirs into their trace files; include rotated generations."""
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, _, files in os.walk(path):
                for name in sorted(files):
                    if re.fullmatch(r"trace.*\.json(\.\d+)?", name):
                        out.append(os.path.join(root, name))
        else:
            out.append(path)
            for rotated in sorted(glob.glob(path + ".[0-9]*")):
                out.append(rotated)
    # stable de-dup
    seen, unique = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            unique.append(p)
    return unique


def merge_traces(paths: List[str]) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Merge trace files onto one absolute timeline.

    Returns ``(merged_events, sources)``.  Each merged event gains
    ``abs_us`` (Unix-epoch µs) plus the source ``role``/``rank``; ``ts`` is
    rebased so the earliest event across all files sits at 0, and each source
    file keeps a distinct ``pid`` so Perfetto shows one track group per
    process.  Files without a ``clock_sync`` anchor fall back to their own
    ``ts`` (mergeable only with files from the same clock).
    """
    loaded = []
    for path in paths:
        meta, events = load_trace(path)
        if events:
            loaded.append((path, meta, events))
    merged: List[Dict[str, Any]] = []
    sources: List[Dict[str, Any]] = []
    for pid, (path, meta, events) in enumerate(loaded):
        anchor = int(meta.get("epoch_t0_us", 0))
        role = str(meta.get("role") or f"proc{pid}")
        rank = meta.get("rank", pid)
        sources.append(
            {
                "path": path,
                "run_id": meta.get("run_id"),
                "role": role,
                "rank": rank,
                "epoch_t0_us": anchor,
                "n_events": len(events),
            }
        )
        for event in events:
            if event.get("ph") == "M":
                continue  # regenerated below with role-qualified names
            e = dict(event)
            e["abs_us"] = anchor + int(e.get("ts", 0))
            e["pid"] = pid
            e.setdefault("args", {})
            e["args"] = {**e["args"], "role": role, "rank": rank}
            merged.append(e)
    if not merged:
        return [], sources
    t0 = min(e["abs_us"] for e in merged)
    for e in merged:
        e["ts"] = e["abs_us"] - t0
    merged.sort(key=lambda e: e["ts"])
    # one process_name metadata event per source so the merged file is
    # self-describing in the Perfetto UI
    preamble = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"{src['role']} rank{src['rank']} ({os.path.basename(src['path'])})"},
        }
        for pid, src in enumerate(sources)
    ]
    return preamble + merged, sources


def run_state_overlay(
    journal_events: List[Dict[str, Any]], pid: int, label: str = "run_state"
) -> List[Dict[str, Any]]:
    """Build run-state spans (with ``abs_us``, un-rebased) from one journal.

    Steady-state spans come from the union of ``state_change`` boundaries and
    the per-interval ``Telemetry/run_state`` gauge points (flood control
    journals steady states at FIRST entry only, so the gauges are what
    segments a long steady stretch); consecutive same-state points coalesce.
    Stalled time is drawn ONLY from the ``stall``/``stall_end`` bounds —
    exactly one span per stall; counting the ``state_change(stalled)``
    boundary too would double-draw it.  A final pre-kill state gets a span to
    the journal's last event, floored at 1 µs so it stays visible/parseable.
    """
    boundaries: List[Tuple[float, Optional[str]]] = []
    stalls: List[Tuple[float, Optional[float]]] = []
    last_t: Optional[float] = None
    open_stall: Optional[float] = None
    for event in journal_events:
        t = event.get("t")
        if not isinstance(t, (int, float)):
            continue
        last_t = t if last_t is None else max(last_t, t)
        kind = event.get("event")
        if kind == "run_start":
            boundaries.append((t, "starting"))
        elif kind == "state_change":
            state = event.get("state")
            boundaries.append((t, None if state == "stalled" else str(state)))
        elif kind == "stall":
            boundaries.append((t, None))
            open_stall = t
        elif kind == "stall_end":
            boundaries.append((t, str(event.get("state") or "training")))
            if open_stall is not None:
                stalls.append((open_stall, t))
                open_stall = None
        elif kind == "run_end":
            boundaries.append((t, None))
        elif kind == "metrics":
            gauge = (event.get("metrics") or {}).get("Telemetry/run_state")
            if isinstance(gauge, (int, float)) and 0 <= int(gauge) < len(STATES):
                state = STATES[int(gauge)]
                boundaries.append((t, None if state == "stalled" else state))
    if open_stall is not None:  # killed while stalled: span to the last event
        stalls.append((open_stall, None))
    if not boundaries or last_t is None:
        return []

    def span(name: str, t_from: float, t_to: float) -> Dict[str, Any]:
        return {
            "name": name,
            "cat": "run_state",  # keeps the overlay out of phase_table
            "ph": "X",
            "abs_us": int(t_from * 1e6),
            "dur": max(1, int((t_to - t_from) * 1e6)),
            "pid": pid,
            "tid": 0,
            "args": {"overlay": label},
        }

    out: List[Dict[str, Any]] = []
    boundaries.sort(key=lambda b: b[0])
    cur_state: Optional[str] = None
    cur_t = boundaries[0][0]
    for t, state in boundaries:
        if state == cur_state:
            continue
        if cur_state is not None and cur_state != "ended":
            out.append(span(cur_state, cur_t, t))
        cur_state, cur_t = state, t
    if cur_state is not None and cur_state != "ended":
        out.append(span(cur_state, cur_t, max(last_t, cur_t)))
    for t_from, t_to in stalls:
        out.append(span("stalled", t_from, t_to if t_to is not None else max(last_t, t_from)))
    return out


def phase_table(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per (role, phase) wall-clock aggregation over merged span events (the
    run-state overlay track is excluded — a `stalled` overlay span is not a
    host phase and would double-count against the stall accounting)."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") != "run_state"]
    if not spans:
        return []
    stats: Dict[Tuple[str, str], Dict[str, float]] = {}
    role_wall: Dict[str, Tuple[int, int]] = {}
    for e in spans:
        role = (e.get("args") or {}).get("role", "?")
        start, end = int(e["ts"]), int(e["ts"]) + int(e.get("dur", 0))
        lo, hi = role_wall.get(role, (start, end))
        role_wall[role] = (min(lo, start), max(hi, end))
        key = (role, str(e["name"]))
        s = stats.setdefault(key, {"count": 0, "total_us": 0})
        s["count"] += 1
        s["total_us"] += int(e.get("dur", 0))
    rows = []
    for (role, phase), s in sorted(stats.items(), key=lambda kv: (kv[0][0], -kv[1]["total_us"])):
        lo, hi = role_wall[role]
        wall = max(1, hi - lo)
        rows.append(
            {
                "role": role,
                "phase": phase,
                "count": int(s["count"]),
                "total_ms": round(s["total_us"] / 1e3, 3),
                "mean_ms": round(s["total_us"] / s["count"] / 1e3, 3),
                "share_pct": round(100.0 * s["total_us"] / wall, 2),
            }
        )
    return rows


def instant_table(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Global instant markers on the merged timeline (``clock_sync`` anchors
    excluded — they are bookkeeping, not run events).  ``ckpt_promote`` on the
    serving track landing between training's ``checkpoint`` spans is the
    cross-process story this table exists to tell."""
    rows: List[Dict[str, Any]] = []
    for e in events:
        if e.get("ph") != "i" or e.get("name") == "clock_sync":
            continue
        rows.append(
            {
                "name": str(e.get("name")),
                "role": (e.get("args") or {}).get("role", "?"),
                "ts_ms": round(int(e.get("ts", 0)) / 1e3, 3),
                "args": {
                    k: v
                    for k, v in (e.get("args") or {}).items()
                    if k not in ("role", "rank")
                },
            }
        )
    rows.sort(key=lambda r: r["ts_ms"])
    return rows


def format_phase_table(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return "no span events found"
    header = f"{'role':<10s} {'phase':<16s} {'count':>7s} {'total ms':>12s} {'mean ms':>10s} {'share':>7s}"
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{r['role']:<10s} {r['phase']:<16s} {r['count']:>7d} "
            f"{r['total_ms']:>12.3f} {r['mean_ms']:>10.3f} {r['share_pct']:>6.1f}%"
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="+", help="trace files and/or run dirs")
    parser.add_argument("--out", metavar="MERGED", help="write the merged Chrome trace to MERGED")
    parser.add_argument("--json", action="store_true", help="print the per-phase table as JSON")
    parser.add_argument(
        "--no-state-overlay",
        action="store_true",
        help="skip the run-state journal overlay track on the merged timeline",
    )
    args = parser.parse_args(argv)

    files = collect_trace_files(args.paths)
    if not files:
        print(f"error: no trace files found under {args.paths}", file=sys.stderr)
        return 2
    merged, sources = merge_traces(files)
    rows = phase_table(merged)
    instants = instant_table(merged)

    # run-state overlay: journals under run-dir args only (file args are
    # traces); each journal gets its own track on the merged timeline
    overlay_info: List[Dict[str, Any]] = []
    if merged and not args.no_state_overlay:
        spans = [e for e in merged if "abs_us" in e]
        t0 = (spans[0]["abs_us"] - spans[0]["ts"]) if spans else 0
        journals = collect_journals([p for p in args.paths if os.path.isdir(p)])
        for pid, journal_path in enumerate(journals, start=len(sources)):
            segment = os.path.basename(os.path.dirname(os.path.abspath(journal_path)))
            track = run_state_overlay(read_journal(journal_path), pid, label=segment)
            if not track:
                continue
            for event in track:
                event["ts"] = event["abs_us"] - t0
            merged.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": f"run_state {segment}"},
                }
            )
            merged.extend(track)
            overlay_info.append(
                {
                    "journal": journal_path,
                    "n_state_spans": sum(1 for e in track if e["name"] != "stalled"),
                    "n_stall_spans": sum(1 for e in track if e["name"] == "stalled"),
                }
            )

    if args.json:
        print(
            json.dumps(
                {
                    "sources": sources,
                    "phases": rows,
                    "instants": instants,
                    "run_state_overlay": overlay_info,
                },
                indent=2,
            )
        )
    else:
        for src in sources:
            print(
                f"source: {src['path']}  role={src['role']} rank={src['rank']} "
                f"({src['n_events']} events)"
            )
        for info in overlay_info:
            print(
                f"overlay: {info['journal']}  ({info['n_state_spans']} state spans, "
                f"{info['n_stall_spans']} stall spans)"
            )
        print()
        print(format_phase_table(rows))
        if instants:
            print()
            print("instant markers:")
            for r in instants[:20]:
                detail = " ".join(f"{k}={v}" for k, v in sorted(r["args"].items()))
                print(f"  {r['ts_ms']:>12.3f} ms  [{r['role']}] {r['name']}  {detail}".rstrip())
            if len(instants) > 20:
                print(f"  ... {len(instants) - 20} more")

    if args.out:
        with open(args.out, "w", encoding="utf-8") as fp:
            json.dump([{k: v for k, v in e.items() if k != "abs_us"} for e in merged], fp)
        print(f"\nwrote merged trace ({len(merged)} events) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
