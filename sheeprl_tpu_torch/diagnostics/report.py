"""Journal analysis (counterpart of ``sheeprl_tpu/diagnostics/report.py``):
the library behind ``python -m sheeprl_tpu_torch.tools.journal_report``
and the other readers under ``sheeprl_tpu_torch/tools/``.

Everything a post-mortem needs without TensorBoard archaeology: run identity
and config hash, the last logged step counter and metric values (including
``Rewards/rew_avg``), checkpoint and divergence timelines, and a CSV export
of the full metric history.  Works on journals from crashed runs: the reader
already skips a truncated trailing line.  The text is the JAX package's, to
the character, from the same journal, and the module imports neither torch
nor anything that does, so a run is read where there is no CUDA; the
journal-reading helpers of ``diagnostics/health.py`` (``metric_series``,
``watched_metric_names``, ``active_anomalies``) live here for that reason.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.diagnostics.journal import find_journal, read_journal


def summarize(path: str) -> Dict[str, Any]:
    """Summarize a journal file (or a run directory containing one)."""
    journal_path = find_journal(path)
    if journal_path is None:
        raise FileNotFoundError(f"No journal.jsonl found under '{path}'")
    events = read_journal(journal_path)
    metrics_events = [e for e in events if e.get("event") == "metrics"]
    checkpoints = [e for e in events if e.get("event") == "checkpoint"]
    divergences = [e for e in events if e.get("event") == "divergence"]
    run_start = next((e for e in events if e.get("event") == "run_start"), None)
    run_end = next((e for e in reversed(events) if e.get("event") == "run_end"), None)

    last_metrics = metrics_events[-1] if metrics_events else None
    last_rew = None
    last_rew_step = None
    for e in reversed(metrics_events):
        rew = (e.get("metrics") or {}).get("Rewards/rew_avg")
        if isinstance(rew, (int, float)):
            last_rew, last_rew_step = float(rew), e.get("step")
            break

    return {
        "journal_path": journal_path,
        "n_events": len(events),
        "run_start": run_start,
        "run_end": run_end,
        # a journal without run_end is the signature of a killed run
        "clean_shutdown": run_end is not None,
        "n_metrics_events": len(metrics_events),
        "last_step": last_metrics.get("step") if last_metrics else None,
        "last_metrics": (last_metrics.get("metrics") or {}) if last_metrics else {},
        "last_rew_avg": last_rew,
        "last_rew_avg_step": last_rew_step,
        "checkpoints": [{"step": e.get("step"), "path": e.get("path")} for e in checkpoints],
        "divergences": divergences,
    }


def to_csv(path: str, out_path: str) -> int:
    """Export the journal's metric history to CSV; returns the row count.

    Columns: ``t``, ``step``, then the union of metric names over the run
    (sorted).  Non-finite values survive as their journal string form
    ("nan"/"inf") so spreadsheet greps for them still work.
    """
    journal_path = find_journal(path)
    if journal_path is None:
        raise FileNotFoundError(f"No journal.jsonl found under '{path}'")
    rows: List[Dict[str, Any]] = []
    keys: List[str] = []
    seen = set()
    for e in read_journal(journal_path):
        if e.get("event") != "metrics":
            continue
        metrics = e.get("metrics") or {}
        rows.append({"t": e.get("t"), "step": e.get("step"), **metrics})
        for k in metrics:
            if k not in seen:
                seen.add(k)
                keys.append(k)
    fieldnames = ["t", "step"] + sorted(keys)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="", encoding="utf-8") as fp:
        writer = csv.DictWriter(fp, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
    return len(rows)


def format_summary(summary: Dict[str, Any]) -> str:
    """Human-readable report (what the CLI prints)."""
    lines = [f"journal: {summary['journal_path']}"]
    start = summary.get("run_start") or {}
    if start:
        lines.append(
            "run:     algo={algo} env={env} seed={seed} config_hash={config_hash}".format(
                algo=start.get("algo", "?"),
                env=start.get("env", "?"),
                seed=start.get("seed", "?"),
                config_hash=start.get("config_hash", "?"),
            )
        )
    end = summary.get("run_end")
    lines.append(
        "status:  "
        + (f"{end.get('status', 'unknown')} (clean shutdown)" if end else "NO run_end event — run was killed or is still going")
    )
    lines.append(f"events:  {summary['n_events']} total, {summary['n_metrics_events']} metric intervals")
    if summary.get("last_step") is not None:
        lines.append(f"last logged step: {summary['last_step']}")
    if summary.get("last_rew_avg") is not None:
        lines.append(
            f"last Rewards/rew_avg: {summary['last_rew_avg']:.4f} (at step {summary['last_rew_avg_step']})"
        )
    if summary.get("last_metrics"):
        lines.append("last metrics:")
        for k, v in sorted(summary["last_metrics"].items()):
            lines.append(f"  {k}: {v}")
    ckpts = summary.get("checkpoints") or []
    lines.append(f"checkpoints: {len(ckpts)}" + (f" (last at step {ckpts[-1]['step']})" if ckpts else ""))
    divs = summary.get("divergences") or []
    if divs:
        lines.append(f"divergence events: {len(divs)}")
        for d in divs[-5:]:
            lines.append(
                "  step {step}: {kind} {detail}".format(
                    step=d.get("step", "?"),
                    kind=d.get("kind", "?"),
                    detail={k: v for k, v in d.items() if k not in ("t", "event", "step", "kind")},
                )
            )
    else:
        lines.append("divergence events: none")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# live formatting (shared by journal_report --follow and run_monitor)


def format_bytes(n: Any) -> str:
    """Human bytes (binary units) — '—' for missing values."""
    if not isinstance(n, (int, float)):
        return "—"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} TiB"  # pragma: no cover - loop always returns


_TELEMETRY_COLUMNS = (
    ("Rewards/rew_avg", "rew", "{:.2f}"),
    ("Telemetry/sps", "sps", "{:.0f}"),
    ("Telemetry/env_steps_per_sec", "env-sps", "{:.0f}"),
    ("Telemetry/fetch_amortization", "fetch-amort", "{:.0f}x"),
    # offline mode (howto/offline_rl.md): the dataset feed replaces env-sps
    ("Telemetry/dataset_read_sps", "dataset-sps", "{:.0f}"),
    ("Telemetry/dataset_epoch", "epoch", "{:.0f}"),
    ("Telemetry/tflops_per_sec", "tflops", "{:.2f}"),
    ("Telemetry/mfu", "mfu", "{:.1%}"),
)


def _phase_summary(metrics: Dict[str, Any]) -> Optional[str]:
    phases = {
        k.rsplit("/", 1)[1]: v
        for k, v in metrics.items()
        if k.startswith("Telemetry/phase_pct/") and isinstance(v, (int, float))
    }
    if not phases:
        return None
    order = ("train", "env", "fetch", "other", "idle")
    keys = [k for k in order if k in phases] + sorted(set(phases) - set(order))
    return " ".join(f"{k}:{phases[k]:.0f}%" for k in keys)


def format_event_line(event: Dict[str, Any]) -> str:
    """One journal event as one compact terminal line (the tail/monitor
    format)."""
    t = event.get("t")
    clock = time.strftime("%H:%M:%S", time.localtime(t)) if isinstance(t, (int, float)) else "--:--:--"
    kind = str(event.get("event", "?"))
    if kind == "metrics":
        metrics = event.get("metrics") or {}
        parts = [f"step {event.get('step')}"]
        for key, label, fmt in _TELEMETRY_COLUMNS:
            value = metrics.get(key)
            if isinstance(value, (int, float)):
                parts.append(f"{label} {fmt.format(value)}")
        phases = _phase_summary(metrics)
        if phases:
            parts.append(phases)
        hbm = metrics.get("Telemetry/hbm_bytes_in_use")
        if isinstance(hbm, (int, float)):
            peak = metrics.get("Telemetry/hbm_peak_bytes")
            hbm_s = format_bytes(hbm)
            if isinstance(peak, (int, float)) and peak > 0:
                hbm_s += f"/{format_bytes(peak)}"
            parts.append(f"hbm {hbm_s}")
        recompiles = metrics.get("Telemetry/recompiles")
        if isinstance(recompiles, (int, float)) and recompiles > 0:
            parts.append(f"recompiles {recompiles:g}")
        return f"[{clock}] {kind:<12s} " + "  ".join(parts)
    payload = {k: v for k, v in event.items() if k not in ("t", "event")}
    if kind == "state_change":
        return f"[{clock}] {kind:<12s} {payload.get('prev')} -> {payload.get('state')}"
    if kind == "stall":
        # `stacks` is a multi-KB forensics blob — never dump it on a tail line
        return (
            f"[{clock}] {'!! STALL':<12s} no progress for {payload.get('idle_s')}s "
            f"(threshold {payload.get('threshold_s')}s, was {payload.get('last_state')}; "
            "thread stacks in the journal)"
        )
    if kind == "stall_end":
        return (
            f"[{clock}] {kind:<12s} recovered after {payload.get('stalled_s')}s "
            f"-> {payload.get('state')}"
        )
    if kind == "profile_capture":
        where = f" -> {payload.get('dir')}" if payload.get("dir") else ""
        return f"[{clock}] {kind:<12s} {payload.get('status')}{where}"
    if kind == "recompile":
        diff = payload.get("diff") or []
        head = "; ".join(str(d) for d in diff[:3])
        return f"[{clock}] {kind:<12s} {payload.get('fn')} #{payload.get('count')}: {head}"
    if kind == "divergence":
        return f"[{clock}] {kind:<12s} step {payload.get('step')}: {payload.get('kind')}"
    if kind == "anomaly":
        window = payload.get("window") or []
        head = ", ".join(f"{v:g}" for v in window[-4:] if isinstance(v, (int, float)))
        return (
            f"[{clock}] {'!! ANOMALY':<12s} {payload.get('kind')} on {payload.get('subject')} "
            f"at step {payload.get('step')} (window tail: {head})"
        )
    if kind == "anomaly_end":
        return (
            f"[{clock}] {kind:<12s} {payload.get('kind')} on {payload.get('subject')} cleared "
            f"at step {payload.get('step')} (active since step {payload.get('since_step')})"
        )
    if kind == "ckpt_end":
        if payload.get("status") == "failed":
            return (
                f"[{clock}] {'!! CKPT-FAIL':<12s} step {payload.get('step')}: "
                f"{str(payload.get('error', ''))[:80]}"
            )
        mode = "blocking" if payload.get("blocking") else "async"
        return (
            f"[{clock}] {kind:<12s} step {payload.get('step')} "
            f"{format_bytes(payload.get('bytes'))} in {payload.get('write_ms')}ms ({mode})"
        )
    if kind == "ckpt_skipped":
        return f"[{clock}] {kind:<12s} {payload.get('path')}: {payload.get('reason')}"
    if kind == "params_reject":
        mark = "!! PARAMS-REJ" if payload.get("escalate") else kind
        return (
            f"[{clock}] {mark:<12s} {payload.get('reason')} at iter {payload.get('iter_num')} "
            f"(staleness {payload.get('staleness')}/{payload.get('budget')}; player on last-good params)"
        )
    if kind == "rollback":
        return (
            f"[{clock}] {'!! ROLLBACK':<12s} restored iter-{payload.get('restored_iter')} snapshot at iter "
            f"{payload.get('iter_num')} ({payload.get('retries_left')}/{payload.get('budget')} retries left): "
            f"{str(payload.get('error', ''))[:60]}"
        )
    if kind == "preempted":
        return (
            f"[{clock}] {'!! PREEMPT':<12s} {payload.get('reason')} at iter "
            f"{payload.get('iter_num')}; emergency checkpoint {payload.get('path')}"
        )
    if kind == "memory_breakdown":
        components = payload.get("components") or {}
        total = sum(v for v in components.values() if isinstance(v, (int, float)))
        return (
            f"[{clock}] {kind:<12s} {len(components)} components, {format_bytes(total)} static"
            f" (source {payload.get('source', '?')})"
        )
    if kind == "sharding_audit":
        flagged = payload.get("flagged_replicated") or []
        head = f"{payload.get('n_leaves')} leaves, {format_bytes(payload.get('total_bytes_per_device'))}/device"
        if flagged:
            head += f"  REPLICATED: {', '.join(str(f) for f in flagged[:3])}"
        return f"[{clock}] {kind:<12s} {payload.get('fn')}: {head}"
    if kind == "host_transfer":
        what = "BLOCKED" if payload.get("blocked") else ("injected d2h" if payload.get("injected") else "detected")
        return f"[{clock}] {kind:<12s} {payload.get('fn')} call #{payload.get('call')}: {what} (policy {payload.get('policy')})"
    if kind == "donation_miss":
        return (
            f"[{clock}] {kind:<12s} {payload.get('fn')}: {payload.get('n_leaves')} leaves kept alive "
            f"({format_bytes(payload.get('bytes'))} not donated)"
        )
    if kind == "oom":
        return f"[{clock}] {kind:<12s} {payload.get('fn')} call #{payload.get('call')}: {str(payload.get('error', ''))[:80]}"
    if kind == "slo_breach":
        return (
            f"[{clock}] {'!! SLO-BREACH':<12s} {payload.get('model') or 'default'}: "
            f"burn {payload.get('burn')} (target {payload.get('target_ms')}ms, "
            f"objective {payload.get('objective')}, window {payload.get('window')})"
        )
    if kind == "slo_breach_end":
        breach_s = payload.get("breach_s")
        took = f" after {breach_s:.0f}s" if isinstance(breach_s, (int, float)) else ""
        return (
            f"[{clock}] {kind:<12s} {payload.get('model') or 'default'} recovered{took} "
            f"(burn {payload.get('burn')})"
        )
    if kind == "slow_request":
        phases = payload.get("phases") or {}
        breakdown = " + ".join(
            f"{name.replace('_ms', '')} {phases[name]:.0f}"
            for name in ("queue_ms", "batch_form_ms", "dispatch_ms", "scatter_ms")
            if isinstance(phases.get(name), (int, float))
        )
        return (
            f"[{clock}] {'!! SLOW-REQ':<12s} {payload.get('request_id')} on "
            f"{payload.get('model') or 'default'}: {payload.get('total_ms')}ms "
            f"({breakdown}ms; width {payload.get('batch_width')}, "
            f"queue depth {payload.get('queue_depth')})"
        )
    detail = " ".join(f"{k}={v}" for k, v in payload.items() if not isinstance(v, (dict, list)))
    return f"[{clock}] {kind:<12s} {detail}".rstrip()


def status_block(events: List[Dict[str, Any]]) -> str:
    """Multi-line run status from a journal event list (run_monitor's view)."""
    run_start = next((e for e in events if e.get("event") == "run_start"), None)
    run_end = next((e for e in reversed(events) if e.get("event") == "run_end"), None)
    metrics_events = [e for e in events if e.get("event") == "metrics"]
    last = metrics_events[-1] if metrics_events else None
    lines = []
    if run_start:
        lines.append(
            "run     {algo} on {env} (seed {seed})  id={rid}".format(
                algo=run_start.get("algo", "?"),
                env=run_start.get("env", "?"),
                seed=run_start.get("seed", "?"),
                rid=run_start.get("run_id", run_start.get("config_hash", "?")),
            )
        )
    age = None
    if events:
        newest = max((e.get("t") for e in events if isinstance(e.get("t"), (int, float))), default=None)
        if newest is not None:
            age = time.time() - newest
    state = f"ended: {run_end.get('status')}" if run_end else "running"
    if age is not None and run_end is None:
        state += f" (last journal write {age:.0f}s ago)"
    lines.append(f"state   {state}")
    if last:
        lines.append(format_event_line(last))
    server = next((e for e in reversed(events) if e.get("event") == "metrics_server"), None)
    if server and server.get("status") == "serving":
        lines.append(f"metrics http://{server.get('host')}:{server.get('port')}/metrics")
    n_div = sum(1 for e in events if e.get("event") == "divergence")
    n_rec = sum(1 for e in events if e.get("event") == "recompile")
    n_ckpt = sum(1 for e in events if e.get("event") == "checkpoint")
    lines.append(f"events  {len(events)} total · {len(metrics_events)} intervals · "
                 f"{n_ckpt} checkpoints · {n_rec} recompiles · {n_div} divergences")
    lines.extend(goodput_status_lines(events, live=run_end is None))
    lines.extend(checkpoint_status_lines(events, live=run_end is None))
    lines.extend(isolation_status_lines(events, live=run_end is None))
    lines.extend(health_status_lines(events, live=run_end is None))
    lines.extend(memory_status_lines(events))
    lines.extend(serving_status_lines(events, live=run_end is None))
    lines.extend(serving_latency_lines(events, live=run_end is None))
    return "\n".join(lines)


#: A live run whose newest verified checkpoint is older than this many
#: observed checkpoint intervals (with a 30 s floor) gets the
#: ``!! NO-RECENT-CKPT`` banner — it would lose everything since then on a
#: preemption.  Shared by the journal view here and run_monitor's --url mode.
NO_RECENT_CKPT_INTERVALS = 3.0

#: Banner fallback when no cadence is observable yet (a single checkpoint so
#: far, or an endpoint that has not exported an interval): age alone past
#: this hard ceiling still fires — the single-stuck-checkpoint run is exactly
#: the case the banner exists for.
NO_RECENT_CKPT_FALLBACK_S = 1800.0


def no_recent_ckpt_banner(age_s: Optional[float], cadence_s: Optional[float]) -> Optional[str]:
    """The ``!! NO-RECENT-CKPT`` banner line (or None): ONE owner for the
    threshold/wording so the journal view and run_monitor's endpoint mode
    can never drift."""
    if age_s is None:
        return None
    if cadence_s:
        if age_s > max(30.0, NO_RECENT_CKPT_INTERVALS * cadence_s):
            return (
                f"!! NO-RECENT-CKPT — newest verified checkpoint is {age_s:.0f}s old "
                f"(~{age_s / cadence_s:.0f} intervals); a preemption now loses everything since"
            )
        return None
    if age_s > NO_RECENT_CKPT_FALLBACK_S:
        return (
            f"!! NO-RECENT-CKPT — newest verified checkpoint is {age_s:.0f}s old "
            "(no cadence observed yet); a preemption now loses everything since"
        )
    return None


def _median(values: List[float]) -> Optional[float]:
    values = sorted(v for v in values if isinstance(v, (int, float)) and v > 0)
    if not values:
        return None
    return values[len(values) // 2]


def checkpoint_status_lines(events: List[Dict[str, Any]], live: bool = True) -> List[str]:
    """The checkpoint-freshness panel (run_monitor + journal_report share
    it): newest checkpoint step/age, verified-write counters from the
    resilience layer's ``ckpt_end`` events, mean write cost, and — live mode
    only — the ``!! NO-RECENT-CKPT`` banner when the newest verified
    checkpoint is older than :data:`NO_RECENT_CKPT_INTERVALS` observed
    checkpoint intervals.  Empty when the run journaled no checkpoints."""
    writes = [
        e
        for e in events
        if e.get("event") == "ckpt_end" and e.get("status", "ok") == "ok"
    ]
    failures = sum(1 for e in events if e.get("event") == "ckpt_end" and e.get("status") == "failed")
    plain = [e for e in events if e.get("event") == "checkpoint"]
    marks = writes or plain
    if not marks:
        return []
    newest = max(marks, key=lambda e: e.get("t") or 0.0)
    step = newest.get("step")
    parts = [f"{len(marks)} written"]
    if step is not None:
        parts.append(f"last step {step}")
    verified = [e for e in writes if e.get("verified")]
    if verified:
        v_step = max(verified, key=lambda e: e.get("t") or 0.0).get("step")
        if v_step is not None and v_step != step:
            parts.append(f"last verified step {v_step}")
        elif v_step is not None:
            parts.append("verified")
    write_ms = [e.get("write_ms") for e in writes if isinstance(e.get("write_ms"), (int, float))]
    if write_ms:
        mode = "async" if any(e.get("blocking") is False for e in writes) else "blocking"
        parts.append(f"mean write {sum(write_ms) / len(write_ms):.0f}ms {mode}")
    if failures:
        parts.append(f"{failures} FAILED")
    age = None
    newest_t = newest.get("t")
    if isinstance(newest_t, (int, float)):
        age = max(0.0, time.time() - newest_t)
        if live:
            parts.append(f"age {age:.0f}s")
    lines = ["ckpts   " + " · ".join(parts)]
    if live:
        ts = sorted(e.get("t") for e in marks if isinstance(e.get("t"), (int, float)))
        cadence = _median([b - a for a, b in zip(ts, ts[1:])])
        if cadence is None:
            # single checkpoint so far: fall back to the metric-interval pace
            mt = sorted(
                e.get("t") for e in events if e.get("event") == "metrics" and isinstance(e.get("t"), (int, float))
            )
            cadence = _median([b - a for a, b in zip(mt, mt[1:])])
        banner = no_recent_ckpt_banner(age, cadence)
        if banner is not None:
            lines.append(banner)
    return lines


def stale_params_banner(staleness: Any, budget: Any) -> Optional[str]:
    """The ``!! STALE-PARAMS`` banner line (or None): ONE owner for the
    threshold/wording so run_monitor's journal and endpoint modes can never
    drift.  Fires once the decoupled player has been fenced off fresh
    trainer params for more than HALF the staleness budget — the window in
    which escalation (emergency snapshot + halt) is approaching."""
    if not isinstance(staleness, (int, float)) or not isinstance(budget, (int, float)):
        return None
    if budget <= 0 or staleness <= budget / 2.0:
        return None
    return (
        f"!! STALE-PARAMS — player is {staleness:.0f} trainer updates behind "
        f"(budget {budget:.0f}); the fence halts the run when the budget is exhausted"
    )


def isolation_status_lines(events: List[Dict[str, Any]], live: bool = True) -> List[str]:
    """The param-staleness / rollback panel (run_monitor + journal_report
    share it): reject/rollback counters, the latest staleness gauge, and —
    live mode only — the ``!! STALE-PARAMS`` banner past half the budget.
    Empty when the run journaled no fencing activity (coupled runs, and
    decoupled runs that never rejected)."""
    rejects = [e for e in events if e.get("event") == "params_reject"]
    rollbacks = [e for e in events if e.get("event") == "rollback"]
    metrics_events = [e for e in events if e.get("event") == "metrics"]
    last = (metrics_events[-1].get("metrics") or {}) if metrics_events else {}
    staleness = last.get("Telemetry/param_staleness")
    if not rejects and not rollbacks and not isinstance(staleness, (int, float)):
        return []
    parts = [f"{len(rejects)} rejects", f"{len(rollbacks)} rollbacks"]
    if isinstance(staleness, (int, float)):
        parts.append(f"staleness {staleness:.0f}")
    if rejects:
        newest = rejects[-1]
        parts.append(f"last reject: {newest.get('reason')} at iter {newest.get('iter_num')}")
    if rollbacks:
        retries_left = rollbacks[-1].get("retries_left")
        if retries_left is not None:
            parts.append(f"{retries_left} retries left")
    lines = ["fencing " + " · ".join(parts)]
    if live:
        budget = rejects[-1].get("budget") if rejects else None
        banner = stale_params_banner(staleness, budget)
        if banner is not None:
            lines.append(banner)
    return lines


def goodput_status_lines(events: List[Dict[str, Any]], live: bool = True) -> List[str]:
    """The run-state / goodput / stall panel (run_monitor + goodput_report
    share it).  ``live=False`` suppresses the ``!! STALLED`` banner — a
    post-mortem over a killed-while-stalled journal states the fact in the
    stall counters instead of shouting about a run that no longer exists.
    Empty when the run journaled no goodput telemetry (pre-ISSUE-8 runs)."""
    from sheeprl_tpu_torch.diagnostics.goodput import journal_run_state, stalled_seconds

    metrics_events = [e for e in events if e.get("event") == "metrics"]
    # only render when the goodput layer actually ran: run_start/run_end alone
    # would map to a state, and a pre-ISSUE-8 journal must not grow a panel
    # implying the layer was active
    has_goodput = any(
        e.get("event") in ("state_change", "stall", "stall_end") for e in events
    ) or any("Telemetry/run_state" in (e.get("metrics") or {}) for e in metrics_events)
    if not has_goodput:
        return []
    freshest = journal_run_state(events)
    last = (metrics_events[-1].get("metrics") or {}) if metrics_events else {}
    lines: List[str] = []
    if freshest is not None:
        parts = [f"run-state {freshest[1]}"]
        goodput = last.get("Telemetry/goodput")
        if isinstance(goodput, (int, float)):
            parts.append(f"goodput {goodput:.1%}")
        ttfs = last.get("Telemetry/time_to_first_step")
        if isinstance(ttfs, (int, float)):
            parts.append(f"first step after {ttfs:.1f}s")
        lines.append("goodput " + " · ".join(parts))
    n_stalls = sum(1 for e in events if e.get("event") == "stall")
    if n_stalls:
        n_profiles = sum(
            1 for e in events if e.get("event") == "profile_capture" and e.get("status") == "ok"
        )
        stall_line = f"stalls  {n_stalls} · {stalled_seconds(events):.1f}s stalled"
        if n_profiles:
            stall_line += f" · {n_profiles} profile capture{'s' if n_profiles != 1 else ''}"
        lines.append(stall_line)
    if live and freshest is not None and freshest[1] == "stalled":
        age = time.time() - freshest[0]
        lines.append(f"!! STALLED — no progress journaled for {max(0.0, age):.0f}s")
    return lines


def health_status_lines(events: List[Dict[str, Any]], live: bool = True) -> List[str]:
    """The learn-health panel (run_monitor, journal_report --follow status
    block and tools/health_report.py share it): the latest
    ``Telemetry/health/*`` gauges, anomaly counters, and — ``live`` mode
    only — an ``!! ANOMALY`` banner while a detector is active.  ``live=False``
    (post-mortem, mirroring the goodput panel) states the open anomalies in
    the counters line instead of shouting about a run that no longer exists.
    Empty when the run journaled no learning-health telemetry."""
    metrics_events = [e for e in events if e.get("event") == "metrics"]
    last = (metrics_events[-1].get("metrics") or {}) if metrics_events else {}
    has_health = any(e.get("event") in ("anomaly", "anomaly_end") for e in events) or any(
        k.startswith("Telemetry/health/") for k in last
    )
    if not has_health:
        return []
    lines: List[str] = []
    parts: List[str] = []
    for key, label, fmt in (
        ("Telemetry/health/grad_norm", "grad-norm", "{:.3g}"),
        ("Telemetry/health/update_ratio", "upd/w", "{:.2g}"),
        ("Telemetry/health/dead_frac", "dead", "{:.0%}"),
        ("Telemetry/health/value_ev", "value-ev", "{:.2f}"),
    ):
        value = last.get(key)
        if isinstance(value, (int, float)):
            parts.append(f"{label} {fmt.format(value)}")
    if parts:
        lines.append("health  " + " · ".join(parts))
    n_anomalies = sum(1 for e in events if e.get("event") == "anomaly")
    open_anomalies = active_anomalies(events)
    if n_anomalies:
        line = f"anomalies  {n_anomalies} fired"
        if open_anomalies:
            line += " · open: " + ", ".join(
                f"{e.get('kind')}({e.get('subject')})" for e in open_anomalies[:4]
            )
        lines.append(line)
    if live and open_anomalies:
        newest = open_anomalies[-1]
        lines.append(
            f"!! ANOMALY — {newest.get('kind')} on {newest.get('subject')} "
            f"(since step {newest.get('step')}; window in the journal)"
        )
    return lines


def memory_status_lines(events: List[Dict[str, Any]]) -> List[str]:
    """The HBM / transfers panel (run_monitor + memory_report share it):
    latest hbm in-use vs peak, buffer/host bytes, and the data-movement
    counters.  Empty when the run journaled no memory telemetry."""
    metrics_events = [e for e in events if e.get("event") == "metrics"]
    last = (metrics_events[-1].get("metrics") or {}) if metrics_events else {}
    lines: List[str] = []
    hbm = last.get("Telemetry/hbm_bytes_in_use")
    if isinstance(hbm, (int, float)):
        breakdown = next((e for e in events if e.get("event") == "memory_breakdown"), None)
        source = (breakdown or {}).get("source", "")
        parts = [f"hbm {format_bytes(hbm)} in use"]
        peak = last.get("Telemetry/hbm_peak_bytes")
        if isinstance(peak, (int, float)) and peak > 0:
            parts[0] += f" / {format_bytes(peak)} peak"
        if source:
            parts[0] += f" ({source})"
        for key, label in (
            ("Telemetry/replay_host_bytes", "replay host"),
            ("Telemetry/replay_disk_bytes", "replay disk"),
            ("Telemetry/replay_device_bytes", "replay HBM"),
            ("Telemetry/host_rss_bytes", "rss"),
        ):
            value = last.get(key)
            if isinstance(value, (int, float)) and value > 0:
                parts.append(f"{label} {format_bytes(value)}")
        lines.append("memory  " + " · ".join(parts))
    n_xfer = sum(1 for e in events if e.get("event") == "host_transfer")
    n_miss = sum(int(e.get("n_leaves", 1)) for e in events if e.get("event") == "donation_miss")
    n_oom = sum(1 for e in events if e.get("event") == "oom")
    audit = next((e for e in events if e.get("event") == "sharding_audit"), None)
    n_flagged = len((audit or {}).get("flagged_replicated") or [])
    if n_xfer or n_miss or n_oom or n_flagged:
        lines.append(
            f"moves   {n_xfer} host transfers · {n_miss} donation-miss leaves · "
            f"{n_flagged} flagged replicated · {n_oom} ooms"
        )
    return lines


def sessions_full_banner(active: Any, capacity: Any) -> Optional[str]:
    """The ``!! SESSIONS-FULL`` banner line (or None): ONE owner for the
    threshold/wording so run_monitor's journal and endpoint modes can never
    drift.  Fires when the session slab is at capacity — every additional
    NEW session now evicts a resident one (journaled ``session_evict``) and
    the evictee replays its episode from a reset state if it comes back."""
    if not isinstance(active, (int, float)) or not isinstance(capacity, (int, float)):
        return None
    if capacity <= 0 or active < capacity:
        return None
    return (
        f"!! SESSIONS-FULL — {active:.0f}/{capacity:.0f} session slots resident; "
        "every new session evicts the LRU one (raise serving.sessions.capacity)"
    )


def serving_status_lines(events: List[Dict[str, Any]], live: bool = True) -> List[str]:
    """The serving panel (run_monitor's journal mode + journal_report share
    it): resident models with their last promoted step, session-layer
    counters, request-log rotation totals, and — live mode only — the
    ``!! SESSIONS-FULL`` banner off the latest metrics heartbeat's
    ``Telemetry/sessions/*`` gauges.  Empty for journals that never served
    (training runs)."""
    serve_start = next((e for e in reversed(events) if e.get("event") == "serve_start"), None)
    if serve_start is None:
        return []
    models = list(serve_start.get("models") or [])
    if not models:
        models = ["default"]
    promotes = [e for e in events if e.get("event") == "ckpt_promote"]
    rejects = [e for e in events if e.get("event") == "ckpt_reject"]
    lines: List[str] = []
    parts = [f"{len(models)} model{'s' if len(models) != 1 else ''}"]
    for name in models:
        step = next(
            (e.get("step") for e in reversed(promotes) if (e.get("model") or "default") == name),
            serve_start.get("ckpt_step") if name == (serve_start.get("model") or "default") else None,
        )
        parts.append(f"{name}@{step if step is not None else '?'}")
    if promotes or rejects:
        parts.append(f"{len(promotes)} promotes · {len(rejects)} rejects")
    lines.append("serving " + " · ".join(parts))
    evicts = [e for e in events if e.get("event") == "session_evict"]
    rotations = [e for e in events if e.get("event") == "request_log_rotate"]
    metrics_events = [e for e in events if e.get("event") == "metrics"]
    last = (metrics_events[-1].get("metrics") or {}) if metrics_events else {}
    active = last.get("Telemetry/sessions/active")
    capacity = last.get("Telemetry/sessions/capacity")
    if evicts or isinstance(active, (int, float)):
        session_parts = []
        if isinstance(active, (int, float)):
            cap_s = f"/{capacity:.0f}" if isinstance(capacity, (int, float)) else ""
            session_parts.append(f"{active:.0f}{cap_s} active")
        session_parts.append(f"{len(evicts)} evictions")
        lines.append("session " + " · ".join(session_parts))
    if rotations:
        rows = sum(int(e.get("rows") or 0) for e in rotations if not e.get("dropped"))
        dropped = sum(int(e.get("rows") or 0) for e in rotations if e.get("dropped"))
        log_line = f"reqlog  {len(rotations)} shards · {rows} rows logged"
        if dropped:
            log_line += f" · {dropped} rows DROPPED (writer backlog)"
        lines.append(log_line)
    if live:
        banner = sessions_full_banner(active, capacity)
        if banner is not None:
            lines.append(banner)
    return lines


def slo_burn_banner(model: str, burn: Any) -> Optional[str]:
    """The ``!! SLO-BURN`` banner line (or None): ONE owner for the
    threshold/wording so run_monitor's journal and endpoint modes can never
    drift.  Fires while the rolling error-budget burn rate exceeds 1.0 —
    the point at which the ``serving.slo.objective`` is being spent faster
    than the window earns it back (howto/serving.md, "Tracing & SLOs")."""
    if not isinstance(burn, (int, float)) or burn <= 1.0:
        return None
    return (
        f"!! SLO-BURN — {model} is burning error budget at {burn:.2f}x "
        "(>1.0 means the latency objective fails if this traffic holds)"
    )


def serving_latency_lines(events: List[Dict[str, Any]], live: bool = True) -> List[str]:
    """The per-model latency-breakdown panel (run_monitor's journal AND
    endpoint modes share it — the endpoint mode synthesizes journal-shaped
    events from the labeled Prometheus series and feeds them here): queue /
    dispatch / scatter p50·p99 from the latest heartbeat's
    ``Telemetry/serve/*_ms_p50|p99`` gauges, the SLO burn gauge, and — live
    mode only — the ``!! SLO-BURN`` banner past 1.0 plus a ``!! SLOW-REQ``
    line naming the most recent journaled ``slow_request`` id.  Empty for
    journals with no serving latency telemetry."""
    last_by_model: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("event") != "metrics":
            continue
        metrics = e.get("metrics") or {}
        if any(k.startswith("Telemetry/serve/") for k in metrics):
            last_by_model[str(e.get("model") or "default")] = metrics
    lines: List[str] = []
    burns: Dict[str, Any] = {}
    for model in sorted(last_by_model):
        metrics = last_by_model[model]
        parts: List[str] = []
        for phase in ("queue", "dispatch", "scatter"):
            p50 = metrics.get(f"Telemetry/serve/{phase}_ms_p50")
            p99 = metrics.get(f"Telemetry/serve/{phase}_ms_p99")
            if isinstance(p50, (int, float)) and isinstance(p99, (int, float)):
                parts.append(f"{phase} {p50:.1f}/{p99:.1f}")
        burn = metrics.get("Telemetry/serve/slo_burn")
        if isinstance(burn, (int, float)):
            parts.append(f"burn {burn:.2f}")
            burns[model] = burn
        shed_wait = metrics.get("Telemetry/serve/shed_wait_ms")
        if isinstance(shed_wait, (int, float)):
            parts.append(f"shed-wait {shed_wait:.1f}ms")
        if parts:
            lines.append(f"latency {model}: " + " · ".join(parts) + "  (p50/p99 ms)")
    if live:
        for model in sorted(burns):
            banner = slo_burn_banner(model, burns[model])
            if banner is not None:
                lines.append(banner)
        slow = next((e for e in reversed(events) if e.get("event") == "slow_request"), None)
        if slow is not None:
            total = slow.get("total_ms")
            took = f" took {total}ms" if isinstance(total, (int, float)) else ""
            lines.append(
                f"!! SLOW-REQ — last slow request {slow.get('request_id')} on "
                f"{slow.get('model') or 'default'}{took} "
                "(full phase breakdown in the journal)"
            )
    return lines


def format_memory_breakdown(event: Dict[str, Any]) -> str:
    """The ``memory_breakdown`` journal event as a footprint table."""
    header = "static footprint breakdown" + (f" (source: {event.get('source', '?')})" if event.get("source") else "")
    if event.get("fsdp_axis_size"):
        header += f" [fsdp axis={event['fsdp_axis_size']}]"
    lines = [header]
    components = event.get("components") or {}
    per_device = event.get("components_per_device") or {}
    total = 0
    total_per_device = 0
    for name, size in sorted(components.items(), key=lambda kv: -(kv[1] if isinstance(kv[1], (int, float)) else 0)):
        if not isinstance(size, (int, float)) or size <= 0:
            continue
        total += size
        row = f"  {name:<24s} {format_bytes(size):>12s}"
        dev = per_device.get(name)
        total_per_device += dev if isinstance(dev, (int, float)) else size
        if isinstance(dev, (int, float)):
            row += f"  ({format_bytes(dev)}/device)"
        lines.append(row)
    total_row = f"  {'total (components)':<24s} {format_bytes(total):>12s}"
    if per_device:
        total_row += f"  ({format_bytes(total_per_device)}/device)"
    lines.append(total_row)
    for fn, analysis in sorted((event.get("executables") or {}).items()):
        lines.append(f"  executable {fn}:")
        for key in ("argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes", "alias_bytes"):
            if key in analysis:
                lines.append(f"    {key.replace('_bytes', ''):<22s} {format_bytes(analysis[key]):>12s}")
    for row in event.get("device_memory") or []:
        lines.append(
            f"  device {row.get('device')}: {format_bytes(row.get('bytes_in_use'))} in use"
            + (f", {format_bytes(row.get('peak_bytes_in_use'))} peak" if row.get("peak_bytes_in_use") else "")
        )
    live = event.get("live_arrays")
    if live:
        lines.append(
            f"  live jax arrays: {live.get('n_arrays')} arrays, {format_bytes(live.get('bytes_in_use'))}"
            f" (largest {format_bytes(live.get('largest_alloc_bytes'))})"
        )
    if event.get("host_rss_bytes") is not None:
        lines.append(f"  process RSS: {format_bytes(event['host_rss_bytes'])}")
    return "\n".join(lines)


def format_sharding_audit(event: Dict[str, Any]) -> str:
    """The ``sharding_audit`` journal event as a per-leaf table (largest
    per-device cost first; replicated leaves marked)."""
    lines = [
        "sharding audit ({fn}): {n} leaves, {total} total, {per_dev}/device".format(
            fn=event.get("fn", "?"),
            n=event.get("n_leaves", "?"),
            total=format_bytes(event.get("total_bytes")),
            per_dev=format_bytes(event.get("total_bytes_per_device")),
        )
    ]
    flagged = set(event.get("flagged_replicated") or [])
    for row in event.get("rows") or []:
        mark = " REPLICATED!" if row.get("path") in flagged else (" repl" if row.get("replicated") else "")
        lines.append(
            "  {per_dev:>12s}/dev  {dtype:<10s} {shape:<18s} x{nd}  {path}{mark}".format(
                per_dev=format_bytes(row.get("bytes_per_device")),
                dtype=str(row.get("dtype", "?")),
                shape=str(row.get("shape", "?")),
                nd=row.get("n_devices", 1),
                path=row.get("path", "?"),
                mark=mark,
            )
        )
    if event.get("hint"):
        lines.append(f"  hint: {event['hint']}")
    return "\n".join(lines)


def format_fsdp_shard_map(event: Dict[str, Any]) -> str:
    """The ``fsdp_shard_map`` journal event: how the partition rule laid out
    each train-state tree over the ``model`` mesh axis."""
    lines = [
        "fsdp shard map: axis_size={axis} min_shard_bytes={floor}".format(
            axis=event.get("axis_size", "?"), floor=event.get("min_shard_bytes", "?")
        )
    ]
    for name, row in sorted((event.get("trees") or {}).items()):
        lines.append(
            "  {name:<12s} {sharded}/{leaves} leaves sharded ({repl} replicated) · "
            "{total} global → {per_dev}/device".format(
                name=name,
                sharded=row.get("sharded", "?"),
                leaves=row.get("leaves", "?"),
                repl=row.get("replicated", "?"),
                total=format_bytes(row.get("bytes")),
                per_dev=format_bytes(row.get("bytes_per_device")),
            )
        )
    return "\n".join(lines)


def metric_series(
    events: List[Dict[str, Any]], name: str
) -> List[Tuple[Optional[float], float]]:
    """``[(step, value)]`` trajectory of one metric over a journal's
    ``metrics`` events (non-numeric values — the journal's "nan"/"inf"
    strings included — are skipped)."""
    out: List[Tuple[Optional[float], float]] = []
    for event in events:
        if event.get("event") != "metrics":
            continue
        value = (event.get("metrics") or {}).get(name)
        if isinstance(value, (int, float)):
            step = event.get("step")
            out.append((float(step) if isinstance(step, (int, float)) else None, float(value)))
    return out


def watched_metric_names(events: List[Dict[str, Any]], prefixes: Sequence[str]) -> List[str]:
    """Sorted union of metric names matching any watch prefix (an exact name
    is its own prefix) over a journal's metrics events."""
    names: set = set()
    for event in events:
        if event.get("event") != "metrics":
            continue
        for name, value in (event.get("metrics") or {}).items():
            if isinstance(value, (int, float)) and any(name.startswith(p) for p in prefixes):
                names.add(name)
    return sorted(names)


def active_anomalies(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Anomaly events without a matching ``anomaly_end`` (keyed kind+subject),
    in firing order: what the ``!! ANOMALY`` banner reports and what the
    serving tier's health gate reads from a training run's journal before it
    promotes that run's checkpoint."""
    open_by_key: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for event in events:
        kind = event.get("event")
        if kind not in ("anomaly", "anomaly_end"):
            continue
        key = (str(event.get("kind")), str(event.get("subject")))
        if kind == "anomaly":
            open_by_key[key] = event
        else:
            open_by_key.pop(key, None)
    return sorted(open_by_key.values(), key=lambda e: e.get("t") or 0.0)
