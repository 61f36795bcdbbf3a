"""Cross-run learning-regression diff (counterpart of the repo's
``tools/health_diff.py``, on the port's run readers): compare two run
journals' watched metric trajectories under configurable tolerance bands.

The CI primitive for "did this PR change learning?": point it at a baseline
run's journal and a candidate run's journal (two runs of the same
experiment) and it exits
**non-zero iff a watched trajectory leaves its tolerance band**:

* each watched metric present in BOTH journals is resampled to ``--points``
  positions along its step range (linear interpolation), so runs with
  different lengths or log cadences compare point-for-point;
* at every resampled position the candidate must stay inside
  ``|cand - base| <= abs_tol + rel_tol * max(|base value|, mean |base|)``
  — a band around the baseline trajectory whose floor (the trajectory's
  mean magnitude) keeps zero-crossing metrics from tripping on noise, and
  whose ``abs_tol`` (default 0.02) is the absolute noise floor: a baseline
  trajectory that sits identically at zero (``dead_frac`` on a healthy run,
  ``Rewards/rew_avg`` on a sparse env) has no magnitude to scale by, so only
  candidate excursions beyond ``abs_tol`` count — lower it explicitly when
  gating small-magnitude metrics;
* a watched metric missing from one journal is reported but is not a
  regression (use ``--strict-missing`` to make it one).

Exit codes: 0 in-band, 1 regression, 2 usage/input error.  It imports no
torch.

Usage:
    python -m sheeprl_tpu_torch.tools.health_diff <baseline run|journal> <candidate run|journal>
    python -m sheeprl_tpu_torch.tools.health_diff base/ cand/ --watch Loss/ Rewards/rew_avg \\
        --rel-tol 0.25 --points 16 --json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.diagnostics.journal import find_journal, read_journal
from sheeprl_tpu_torch.diagnostics.report import metric_series, watched_metric_names

#: default watch set: the learning curves + the in-graph health gauges
DEFAULT_WATCH = ("Loss/", "Rewards/rew_avg", "Telemetry/health/")


def resample(series: List[Tuple[Optional[float], float]], points: int) -> List[float]:
    """Linear-interpolate a ``metric_series`` trajectory at ``points``
    fractional positions of its step range (event order stands in for steps
    when the journal carries none), so trajectories of different lengths and
    log cadences align point-for-point."""
    if not series:
        return []
    xs: List[float] = []
    for i, (step, _) in enumerate(series):
        xs.append(float(step) if step is not None else float(i))
    ys = [v for _, v in series]
    if len(ys) == 1:
        return [ys[0]] * points
    lo, hi = xs[0], xs[-1]
    if hi <= lo:  # degenerate step range: fall back to event order
        xs = [float(i) for i in range(len(ys))]
        lo, hi = 0.0, float(len(ys) - 1)
    out: List[float] = []
    j = 0
    for p in range(points):
        x = lo + (hi - lo) * (p / (points - 1) if points > 1 else 0.0)
        while j + 1 < len(xs) - 1 and xs[j + 1] < x:
            j += 1
        x0, x1 = xs[j], xs[j + 1]
        y0, y1 = ys[j], ys[j + 1]
        t = 0.0 if x1 <= x0 else min(1.0, max(0.0, (x - x0) / (x1 - x0)))
        out.append(y0 + t * (y1 - y0))
    return out


def compare_metric(
    base: List[float], cand: List[float], rel_tol: float, abs_tol: float
) -> Dict[str, Any]:
    """Band check of one resampled trajectory pair; the band floor is the
    baseline's mean magnitude so near-zero crossings don't trip on noise,
    and ``abs_tol`` is the absolute floor carrying identically-zero
    baselines (where the relative term has nothing to scale by)."""
    scale = sum(abs(v) for v in base) / max(1, len(base))
    worst: Optional[Dict[str, Any]] = None
    out_of_band = 0
    for i, (b, c) in enumerate(zip(base, cand)):
        band = abs_tol + rel_tol * max(abs(b), scale)
        deviation = abs(c - b)
        if deviation > band:
            out_of_band += 1
        excess = deviation - band
        if worst is None or excess > worst["excess"]:
            worst = {
                "position": i,
                "base": round(b, 6),
                "cand": round(c, 6),
                "deviation": round(deviation, 6),
                "band": round(band, 6),
                "excess": round(excess, 6),
            }
    return {
        "points": len(base),
        "out_of_band": out_of_band,
        "regression": out_of_band > 0,
        "worst": worst,
        "base_last": round(base[-1], 6) if base else None,
        "cand_last": round(cand[-1], 6) if cand else None,
    }


def diff_journals(
    base_events: List[Dict[str, Any]],
    cand_events: List[Dict[str, Any]],
    watch: Sequence[str] = DEFAULT_WATCH,
    rel_tol: float = 0.25,
    abs_tol: float = 0.02,
    points: int = 16,
) -> Dict[str, Any]:
    """Full diff of two journals' watched trajectories (library entry for
    tests and CI wrappers)."""
    base_names = set(watched_metric_names(base_events, watch))
    cand_names = set(watched_metric_names(cand_events, watch))
    metrics: Dict[str, Any] = {}
    for name in sorted(base_names & cand_names):
        base = resample(metric_series(base_events, name), points)
        cand = resample(metric_series(cand_events, name), points)
        if base and cand:
            metrics[name] = compare_metric(base, cand, rel_tol, abs_tol)
    regressions = sorted(n for n, r in metrics.items() if r["regression"])
    base_anoms = sum(1 for e in base_events if e.get("event") == "anomaly")
    cand_anoms = sum(1 for e in cand_events if e.get("event") == "anomaly")
    return {
        "metrics": metrics,
        "regressions": regressions,
        "missing_in_candidate": sorted(base_names - cand_names),
        "missing_in_baseline": sorted(cand_names - base_names),
        "anomalies": {"baseline": base_anoms, "candidate": cand_anoms},
        "rel_tol": rel_tol,
        "abs_tol": abs_tol,
        "points": points,
    }


def format_diff(result: Dict[str, Any]) -> str:
    lines = [
        "health diff: {n} watched trajectories · rel_tol {rt:g} · abs_tol {at:g} · {p} points".format(
            n=len(result["metrics"]), rt=result["rel_tol"], at=result["abs_tol"], p=result["points"]
        )
    ]
    for name, r in sorted(result["metrics"].items()):
        mark = "REGRESSION" if r["regression"] else "ok"
        line = (
            f"  {mark:<10s} {name:<40s} last {r['base_last']:g} -> {r['cand_last']:g}"
            f" · {r['out_of_band']}/{r['points']} points out of band"
        )
        if r["regression"] and r["worst"]:
            w = r["worst"]
            line += (
                f" (worst at {w['position']}: |{w['cand']:g} - {w['base']:g}|"
                f" = {w['deviation']:g} > band {w['band']:g})"
            )
        lines.append(line)
    for name in result["missing_in_candidate"]:
        lines.append(f"  MISSING    {name} (in baseline, not in candidate)")
    for name in result["missing_in_baseline"]:
        lines.append(f"  new        {name} (in candidate only)")
    anoms = result["anomalies"]
    lines.append(f"  anomalies  baseline {anoms['baseline']} · candidate {anoms['candidate']}")
    if result["regressions"]:
        lines.append(
            f"RESULT: REGRESSION — {len(result['regressions'])} trajectories left their band: "
            + ", ".join(result["regressions"])
        )
    else:
        lines.append("RESULT: ok — every watched trajectory stayed inside its band")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("baseline", help="baseline run dir or journal.jsonl")
    parser.add_argument("candidate", help="candidate run dir or journal.jsonl")
    parser.add_argument(
        "--watch",
        nargs="*",
        default=list(DEFAULT_WATCH),
        help="metric name prefixes to compare (exact names are their own prefix)",
    )
    parser.add_argument("--rel-tol", type=float, default=0.25, help="relative band half-width")
    parser.add_argument(
        "--abs-tol",
        type=float,
        default=0.02,
        help="absolute band half-width — the noise floor for identically-zero baselines",
    )
    parser.add_argument("--points", type=int, default=16, help="resample positions per trajectory")
    parser.add_argument(
        "--strict-missing",
        action="store_true",
        help="a watched baseline metric missing from the candidate is a regression too",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    if args.points < 2:
        print("error: --points must be >= 2", file=sys.stderr)
        return 2
    paths = []
    for label, path in (("baseline", args.baseline), ("candidate", args.candidate)):
        journal = find_journal(path)
        if journal is None:
            print(f"error: no journal.jsonl found under {label} '{path}'", file=sys.stderr)
            return 2
        paths.append(journal)
    base_events, cand_events = read_journal(paths[0]), read_journal(paths[1])
    result = diff_journals(
        base_events,
        cand_events,
        watch=tuple(args.watch),
        rel_tol=args.rel_tol,
        abs_tol=args.abs_tol,
        points=args.points,
    )
    failed = bool(result["regressions"]) or (
        args.strict_missing and bool(result["missing_in_candidate"])
    )
    if args.json:
        result["baseline_journal"], result["candidate_journal"] = paths
        result["failed"] = failed
        print(json.dumps(result, indent=2))
    else:
        print(f"baseline:  {paths[0]}")
        print(f"candidate: {paths[1]}")
        print(format_diff(result))
        if args.strict_missing and result["missing_in_candidate"]:
            print("RESULT: REGRESSION — watched baseline metrics missing from the candidate")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
