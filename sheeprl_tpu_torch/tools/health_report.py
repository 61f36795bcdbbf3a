"""Per-run learning-health post-mortem from a run's crash-safe journal.

The port's counterpart of ``tools/health_report.py``: the same arguments and,
from the same run, the same output; it imports neither torch nor JAX, so it
reads a run wherever the run's files are.

Renders what the live ``Telemetry/health/*`` gauges (in-graph grad/update/
param statistics, ``howto/learn_health.md``) and the anomaly detectors said
over a whole run, without TensorBoard archaeology:

* trajectory tables for the global health stats and — when the run collected
  per-module detail (``diagnostics=full``) — one row per module per stat
  (first / min / max / last over the run);
* the watched loss/reward trajectories the anomaly detectors and
  ``tools/health_diff.py`` care about;
* the anomaly timeline: every ``anomaly`` / ``anomaly_end`` pair with its
  offending window, plus the detectors still open when the journal ends
  (banner suppressed — this is a post-mortem view; ``tools/run_monitor.py``
  keeps the live ``!! ANOMALY`` banner).

Usage:
    python -m sheeprl_tpu_torch.tools.health_report logs/runs/ppo/CartPole-v1/<run>/
    python -m sheeprl_tpu_torch.tools.health_report <run dir | journal.jsonl> --json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from sheeprl_tpu_torch.diagnostics.journal import find_journal, read_journal
from sheeprl_tpu_torch.diagnostics.report import (
    active_anomalies,
    health_status_lines,
    metric_series,
    watched_metric_names,
)

#: what the trajectory tables cover by default (health gauges + the watched
#: learning curves); --watch replaces it
DEFAULT_WATCH = ("Telemetry/health/", "Loss/", "Rewards/rew_avg")


def series_summary(series: List) -> Optional[Dict[str, Any]]:
    """first/min/max/last summary of one ``metric_series`` trajectory."""
    values = [v for _, v in series]
    if not values:
        return None
    steps = [s for s, _ in series if s is not None]
    return {
        "n": len(values),
        "first": values[0],
        "min": min(values),
        "max": max(values),
        "last": values[-1],
        "last_step": steps[-1] if steps else None,
    }


def analyze(events: List[Dict[str, Any]], watch=DEFAULT_WATCH) -> Dict[str, Any]:
    """Machine-readable learn-health post-mortem of one journal."""
    run_start = next((e for e in events if e.get("event") == "run_start"), None)
    anomalies = [e for e in events if e.get("event") == "anomaly"]
    anomaly_ends = [e for e in events if e.get("event") == "anomaly_end"]
    trajectories: Dict[str, Any] = {}
    for name in watched_metric_names(events, watch):
        summary = series_summary(metric_series(events, name))
        if summary is not None:
            trajectories[name] = summary
    summary_event = next(
        (e for e in reversed(events) if e.get("event") == "telemetry_summary"), None
    )
    return {
        "run_start": run_start,
        "trajectories": trajectories,
        "anomalies": anomalies,
        "anomaly_ends": anomaly_ends,
        "open_anomalies": active_anomalies(events),
        "health_anomalies_total": (summary_event or {}).get("health_anomalies"),
    }


def _fmt(value: Any) -> str:
    if isinstance(value, (int, float)):
        return f"{value:.4g}"
    return "—"


def format_report(journal_path: str, analysis: Dict[str, Any], events) -> str:
    lines = [f"journal: {journal_path}"]
    start = analysis.get("run_start") or {}
    if start:
        lines.append(
            "run:     algo={algo} env={env} seed={seed}".format(
                algo=start.get("algo", "?"), env=start.get("env", "?"), seed=start.get("seed", "?")
            )
        )
    lines.extend(health_status_lines(events, live=False))

    trajectories = analysis["trajectories"]
    module_rows = {k: v for k, v in trajectories.items() if "/health/module/" in k}
    plain_rows = {k: v for k, v in trajectories.items() if k not in module_rows}
    if plain_rows:
        lines.append("")
        lines.append(f"{'metric':<36s} {'first':>10s} {'min':>10s} {'max':>10s} {'last':>10s} {'n':>5s}")
        lines.append("-" * 86)
        for name in sorted(plain_rows):
            s = plain_rows[name]
            lines.append(
                f"{name:<36s} {_fmt(s['first']):>10s} {_fmt(s['min']):>10s} "
                f"{_fmt(s['max']):>10s} {_fmt(s['last']):>10s} {s['n']:>5d}"
            )
    if module_rows:
        lines.append("")
        lines.append("per-module trajectories:")
        lines.append(f"{'module/stat':<36s} {'first':>10s} {'min':>10s} {'max':>10s} {'last':>10s}")
        lines.append("-" * 80)
        for name in sorted(module_rows):
            s = module_rows[name]
            short = name.split("/health/module/", 1)[1]
            lines.append(
                f"{short:<36s} {_fmt(s['first']):>10s} {_fmt(s['min']):>10s} "
                f"{_fmt(s['max']):>10s} {_fmt(s['last']):>10s}"
            )

    anomalies = analysis["anomalies"]
    lines.append("")
    if anomalies:
        lines.append(f"anomaly timeline ({len(anomalies)} fired):")
        ends = {
            (e.get("kind"), e.get("subject"), e.get("since_step")): e
            for e in analysis["anomaly_ends"]
        }
        for a in anomalies:
            t = a.get("t")
            clock = (
                time.strftime("%H:%M:%S", time.localtime(t))
                if isinstance(t, (int, float))
                else "--:--:--"
            )
            end = ends.get((a.get("kind"), a.get("subject"), a.get("step")))
            until = f" -> cleared at step {end.get('step')}" if end else "  (never cleared)"
            window = ", ".join(
                f"{v:g}" for v in (a.get("window") or [])[-4:] if isinstance(v, (int, float))
            )
            lines.append(
                f"  [{clock}] {a.get('kind')} on {a.get('subject')} at step {a.get('step')}"
                f"{until}  (window tail: {window})"
            )
    else:
        lines.append("anomaly timeline: none fired")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", help="journal.jsonl, a version_N dir, or a run dir")
    parser.add_argument(
        "--watch",
        nargs="*",
        default=list(DEFAULT_WATCH),
        help="metric name prefixes for the trajectory tables",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    journal_path = find_journal(args.path)
    if journal_path is None:
        print(f"error: no journal.jsonl found under '{args.path}'", file=sys.stderr)
        return 2
    events = read_journal(journal_path)
    analysis = analyze(events, watch=tuple(args.watch))
    if args.json:
        print(json.dumps(analysis, indent=2, default=str))
    else:
        print(format_report(journal_path, analysis, events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
