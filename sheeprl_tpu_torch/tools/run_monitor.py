"""Terminal dashboard for a live or finished training run (counterpart of
the repo's ``tools/run_monitor.py``, on the port's run readers).

Two sources, one view:

* **journal mode** (default): tail the run's crash-safe ``journal.jsonl``;
  any run, local or on a shared file system, no ports needed;
* **endpoint mode** (``--url http://host:port``): poll the run's live
  ``/metrics`` (``diagnostics.telemetry.http.enabled=True``) across
  machines.  A serving endpoint (``python -m sheeprl_tpu_torch serve``) is
  recognized by its ``sheeprl_serve_*`` family and renders the request
  panel (req/s, p50/p99 latency, batch width, queue depth, promotions;
  ``!! UNHEALTHY-CKPT`` while the last promotion was rejected) and the
  per-model latency panel (``!! SLO-BURN``, ``!! SLOW-REQ``) through
  ``report.serving_latency_lines``, as journal mode does.

It shows the run's identity and state, the latest metric interval, the
run-state and goodput panel (``!! STALLED``), the learning-health panel
(``!! ANOMALY``), checkpoints (``!! NO-RECENT-CKPT``), the fence
(``!! STALE-PARAMS``), device memory and the counters; with ``--follow``
it streams every new journal row as one line, in the format of
``python -m sheeprl_tpu_torch.tools.journal_report --follow``.  It imports
no torch.

Usage:
    python -m sheeprl_tpu_torch.tools.run_monitor logs/runs/<root_dir>/<run>/
    python -m sheeprl_tpu_torch.tools.run_monitor <run dir> --follow
    python -m sheeprl_tpu_torch.tools.run_monitor --url http://127.0.0.1:8765 --follow
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Any, Dict, Iterator, List, Optional

from sheeprl_tpu_torch.diagnostics.goodput import STATES
from sheeprl_tpu_torch.diagnostics.journal import find_journal
from sheeprl_tpu_torch.diagnostics.report import (
    format_bytes,
    format_event_line,
    no_recent_ckpt_banner,
    serving_latency_lines,
    sessions_full_banner,
    stale_params_banner,
    status_block,
)

_PROM_LINE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?P<labels>\{[^}]*\})?\s+(?P<value>\S+)$")


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


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Minimal Prometheus text parse: ``{metric: value}`` plus label sets for
    the info/phase metrics (enough for the dashboard, not a full parser)."""
    out: Dict[str, Any] = {"_labels": {}}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        match = _PROM_LINE.match(line)
        if not match:
            continue
        name = match.group("name")
        labels_raw = match.group("labels") or ""
        labels = dict(re.findall(r'(\w+)="([^"]*)"', labels_raw))
        try:
            value = float(match.group("value"))
        except ValueError:
            continue
        if labels:
            out["_labels"].setdefault(name, []).append((labels, value))
        out[name] = value
    return out


def endpoint_status(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url.rstrip("/") + "/metrics", timeout=5) as resp:
        metrics = parse_prometheus(resp.read().decode())
    lines = []
    info_sets = metrics["_labels"].get("sheeprl_run_info") or []
    if info_sets:
        info = info_sets[0][0]
        lines.append(
            "run     {algo} on {env}  id={rid}  role={role}".format(
                algo=info.get("algo", "?"),
                env=info.get("env", "?"),
                rid=info.get("run_id", "?"),
                role=info.get("role", "?"),
            )
        )
    lag = metrics.get("sheeprl_journal_lag_seconds")
    state = "serving"
    run_state = metrics.get("sheeprl_run_state")
    stalled = False
    if run_state is not None and 0 <= int(run_state) < len(STATES):
        state_name = STATES[int(run_state)]
        stalled = state_name == "stalled"
        state += f" · run-state {state_name}"
    if lag is not None:
        state += f" (last journal write {lag:.0f}s ago)"
    lines.append(f"state   {state}")
    if stalled:
        banner = "!! STALLED — the watchdog sees no training progress"
        if lag is not None:
            banner += f" (journal lag {lag:.0f}s)"
        lines.append(banner)
    if metrics.get("sheeprl_serve_requests_total") is not None:
        # a serving endpoint, not a training run: request
        # gauges instead of train telemetry, plus the promotion-health banner
        if metrics.get("sheeprl_serve_last_promote_rejected"):
            lines.append(
                "!! UNHEALTHY-CKPT — the last checkpoint promotion was rejected "
                "(health gate / shape mismatch); still serving "
                f"step {metrics.get('sheeprl_serve_ckpt_step', 0):g}"
            )
        serve_parts = []
        for key, label, fmt in (
            ("sheeprl_serve_ckpt_step", "ckpt-step", "{:g}"),
            ("sheeprl_serve_requests_per_sec", "req/s", "{:.1f}"),
            ("sheeprl_serve_latency_p50_ms", "p50", "{:.1f}ms"),
            ("sheeprl_serve_latency_p99_ms", "p99", "{:.1f}ms"),
            ("sheeprl_serve_batch_width_mean", "batch", "{:.1f}"),
            ("sheeprl_serve_queue_depth", "queue", "{:.0f}"),
        ):
            value = metrics.get(key)
            if value is not None:
                serve_parts.append(f"{label} {fmt.format(value)}")
        if serve_parts:
            lines.append("serving " + "  ".join(serve_parts))

        # per-model breakdown when the registry holds several residents: the
        # serve/sessions families carry {model="..."} series next to the
        # unlabeled aggregates the lines above read
        def _model_value(name: str, model: str) -> Optional[float]:
            for labels, value in metrics["_labels"].get(name) or []:
                if labels.get("model") == model and len(labels) == 1:
                    return value
            return None

        model_steps = {
            labels["model"]: value
            for labels, value in metrics["_labels"].get("sheeprl_serve_ckpt_step") or []
            if labels.get("model") and len(labels) == 1
        }
        if len(model_steps) >= 2:
            for model in sorted(model_steps):
                row = [f"ckpt-step {model_steps[model]:g}"]
                requests = _model_value("sheeprl_serve_requests_total", model)
                if requests is not None:
                    row.append(f"{requests:g} requests")
                active = _model_value("sheeprl_sessions_active", model)
                if active is not None:
                    capacity = _model_value("sheeprl_sessions_capacity", model)
                    row.append(
                        f"sessions {active:g}"
                        + (f"/{capacity:g}" if capacity is not None else "")
                    )
                    evictions = _model_value("sheeprl_sessions_evictions_total", model)
                    if evictions:
                        row.append(f"{evictions:g} evicted")
                if _model_value("sheeprl_serve_last_promote_rejected", model):
                    row.append("REJECTED-CKPT")
                lines.append(f"model   {model}: " + " · ".join(row))
        # the per-model latency-breakdown panel: synthesize journal-shaped
        # metrics events from the {model="..."} series (plus the unlabeled
        # aggregate as a "default" fallback) and feed the SAME
        # report.serving_latency_lines helper the journal mode uses — one
        # owner for the panel layout and the !! SLO-BURN / !! SLOW-REQ
        # wording, so the two modes can never drift
        latency_by_model: Dict[str, Dict[str, float]] = {}
        for prom_name, telemetry_key in (
            ("sheeprl_serve_queue_ms_p50", "Telemetry/serve/queue_ms_p50"),
            ("sheeprl_serve_queue_ms_p99", "Telemetry/serve/queue_ms_p99"),
            ("sheeprl_serve_dispatch_ms_p50", "Telemetry/serve/dispatch_ms_p50"),
            ("sheeprl_serve_dispatch_ms_p99", "Telemetry/serve/dispatch_ms_p99"),
            ("sheeprl_serve_scatter_ms_p50", "Telemetry/serve/scatter_ms_p50"),
            ("sheeprl_serve_scatter_ms_p99", "Telemetry/serve/scatter_ms_p99"),
            ("sheeprl_serve_slo_burn", "Telemetry/serve/slo_burn"),
            ("sheeprl_serve_shed_wait_ms", "Telemetry/serve/shed_wait_ms"),
        ):
            labeled = [
                (labels["model"], value)
                for labels, value in metrics["_labels"].get(prom_name) or []
                if labels.get("model") and len(labels) == 1
            ]
            if labeled:
                for model, value in labeled:
                    latency_by_model.setdefault(model, {})[telemetry_key] = value
            elif metrics.get(prom_name) is not None:
                latency_by_model.setdefault("default", {})[telemetry_key] = metrics[prom_name]
        synthetic: List[Dict[str, Any]] = [
            {"event": "metrics", "model": model, "metrics": values}
            for model, values in latency_by_model.items()
        ]
        info_labels = info_sets[0][0] if info_sets else {}
        slow_id = info_labels.get("last_slow_request_id")
        if slow_id:
            synthetic.append({"event": "slow_request", "request_id": slow_id})
        lines.extend(serving_latency_lines(synthetic, live=True))
        sessions_active = metrics.get("sheeprl_sessions_active")
        if sessions_active is not None:
            sessions_capacity = metrics.get("sheeprl_sessions_capacity")
            session_parts = [
                f"{sessions_active:g}"
                + (f"/{sessions_capacity:g}" if sessions_capacity is not None else "")
                + " active"
            ]
            for key, label in (
                ("sheeprl_sessions_created_total", "created"),
                ("sheeprl_sessions_evictions_total", "evictions"),
                ("sheeprl_sessions_overflow_total", "overflow"),
            ):
                value = metrics.get(key)
                if value is not None:
                    session_parts.append(f"{value:g} {label}")
            lines.append("session " + " · ".join(session_parts))
            banner = sessions_full_banner(sessions_active, sessions_capacity)
            if banner is not None:
                lines.append(banner)
        serve_counters = []
        for key, label in (
            ("sheeprl_serve_requests_total", "requests"),
            ("sheeprl_serve_dispatches_total", "dispatches"),
            ("sheeprl_serve_request_errors_total", "errors"),
            ("sheeprl_serve_shed_total", "shed"),
            ("sheeprl_serve_ckpt_promotions_total", "promotions"),
            ("sheeprl_serve_ckpt_rejections_total", "rejections"),
            ("sheeprl_serve_request_log_rows_total", "rows logged"),
        ):
            value = metrics.get(key)
            if value is not None:
                serve_counters.append(f"{value:g} {label}")
        if serve_counters:
            lines.append("totals  " + " · ".join(serve_counters))
        return "\n".join(lines)
    ckpt_step = metrics.get("sheeprl_ckpt_last_step")
    ckpt_age = metrics.get("sheeprl_ckpt_age_seconds")
    ckpt_interval = metrics.get("sheeprl_ckpt_interval_seconds")
    if ckpt_step is not None or ckpt_age is not None:
        ckpt_parts = []
        if ckpt_step is not None:
            ckpt_parts.append(f"last step {ckpt_step:g}")
        if ckpt_age is not None:
            ckpt_parts.append(f"age {ckpt_age:.0f}s")
        if ckpt_interval is not None:
            ckpt_parts.append(f"every ~{ckpt_interval:.0f}s")
        lines.append("ckpts   " + " · ".join(ckpt_parts))
        banner = no_recent_ckpt_banner(ckpt_age, ckpt_interval)
        if banner is not None:
            lines.append(banner)
    staleness = metrics.get("sheeprl_param_staleness")
    if staleness is not None:
        fence_parts = [f"staleness {staleness:g}"]
        budget = metrics.get("sheeprl_param_staleness_budget")
        if budget is not None:
            fence_parts[0] += f"/{budget:g}"
        for key, label in (
            ("sheeprl_params_rejected_total", "rejects"),
            ("sheeprl_rollbacks_total", "rollbacks"),
        ):
            value = metrics.get(key)
            if value is not None:
                fence_parts.append(f"{value:g} {label}")
        lines.append("fencing " + " · ".join(fence_parts))
        banner = stale_params_banner(staleness, budget)
        if banner is not None:
            lines.append(banner)
    active_anomalies = metrics.get("sheeprl_health_anomalies")
    if active_anomalies:
        info = metrics["_labels"].get("sheeprl_run_info") or []
        which = (info[0][0].get("health_active_anomalies") if info else None) or ""
        lines.append(
            f"!! ANOMALY — {active_anomalies:g} learning-health detector(s) active"
            + (f": {which}" if which else "")
        )
    parts = []
    steps = metrics.get("sheeprl_policy_steps_total")
    if steps is not None:
        parts.append(f"step {steps:g}")
    for key, label, fmt in (
        ("sheeprl_sps", "sps", "{:.0f}"),
        ("sheeprl_env_steps_per_sec", "env-sps", "{:.0f}"),
        ("sheeprl_fetch_amortization", "fetch-amort", "{:.0f}x"),
        # offline mode: the dataset feed replaces env throughput
        ("sheeprl_dataset_read_sps", "dataset-sps", "{:.0f}"),
        ("sheeprl_dataset_epoch", "epoch", "{:.0f}"),
        ("sheeprl_tflops_per_sec", "tflops", "{:.2f}"),
        ("sheeprl_mfu", "mfu", "{:.1%}"),
        ("sheeprl_goodput", "goodput", "{:.1%}"),
        ("sheeprl_time_to_first_step", "first-step", "{:.1f}s"),
    ):
        value = metrics.get(key)
        if value is not None:
            parts.append(f"{label} {fmt.format(value)}")
    phases = sorted(
        (name[len("sheeprl_phase_pct_"):], value)
        for name, value in metrics.items()
        if name.startswith("sheeprl_phase_pct_")
    )
    if phases:
        parts.append(" ".join(f"{k}:{v:.0f}%" for k, v in phases))
    if parts:
        lines.append("latest  " + "  ".join(parts))
    mem_parts = []
    hbm = metrics.get("sheeprl_hbm_bytes_in_use")
    if hbm is not None:
        part = f"hbm {format_bytes(hbm)} in use"
        peak = metrics.get("sheeprl_hbm_peak_bytes")
        if peak:
            part += f" / {format_bytes(peak)} peak"
        mem_parts.append(part)
    for key, label in (
        ("sheeprl_replay_host_bytes", "replay host"),
        ("sheeprl_replay_disk_bytes", "replay disk"),
        ("sheeprl_replay_device_bytes", "replay HBM"),
        ("sheeprl_host_rss_bytes", "rss"),
    ):
        value = metrics.get(key)
        if value:
            mem_parts.append(f"{label} {format_bytes(value)}")
    if mem_parts:
        lines.append("memory  " + " · ".join(mem_parts))
    health_parts = []
    for key, label, fmt in (
        ("sheeprl_health_grad_norm", "grad-norm", "{:.3g}"),
        ("sheeprl_health_update_ratio", "upd/w", "{:.2g}"),
        ("sheeprl_health_dead_frac", "dead", "{:.0%}"),
        ("sheeprl_health_value_ev", "value-ev", "{:.2f}"),
    ):
        value = metrics.get(key)
        if value is not None:
            health_parts.append(f"{label} {fmt.format(value)}")
    if health_parts:
        lines.append("health  " + " · ".join(health_parts))
    counters = []
    for key, label in (
        ("sheeprl_recompiles_total", "recompiles"),
        ("sheeprl_recompile_storms_total", "storms"),
        ("sheeprl_sentinel_events_total", "sentinel events"),
        ("sheeprl_backend_compiles_total", "compiles"),
        ("sheeprl_stalls_total", "stalls"),
        ("sheeprl_stalled_seconds_total", "stalled s"),
        ("sheeprl_host_transfers_total", "host transfers"),
        ("sheeprl_donation_miss_leaves_total", "donation-miss leaves"),
        ("sheeprl_oom_events_total", "ooms"),
        ("sheeprl_health_anomalies_total", "health anomalies"),
        ("sheeprl_ckpts_written_total", "ckpts written"),
        ("sheeprl_ckpt_failures_total", "ckpt failures"),
        ("sheeprl_params_rejected_total", "params rejected"),
        ("sheeprl_rollbacks_total", "rollbacks"),
        ("sheeprl_restarts_total", "restarts"),
    ):
        value = metrics.get(key)
        if value is not None:
            counters.append(f"{value:g} {label}")
    if counters:
        lines.append("totals  " + " · ".join(counters))
    return "\n".join(lines)


def run_journal_mode(path: str, follow: bool, interval: float) -> int:
    journal_path = find_journal(path)
    if journal_path is None:
        print(f"error: no journal.jsonl found under '{path}'", file=sys.stderr)
        return 2
    events: List[Dict[str, Any]] = list(tail_journal(journal_path, follow=False))
    print(f"journal: {journal_path}")
    print(status_block(events))
    if not follow:
        return 0
    print("-" * 72)
    # stream rows from where the snapshot stopped
    seen = len(events)
    try:
        for i, event in enumerate(tail_journal(journal_path, poll_s=interval, follow=True)):
            if i < seen:
                continue
            print(format_event_line(event), flush=True)
            if event.get("event") == "run_end":
                return 0
    except KeyboardInterrupt:
        pass
    return 0


def run_endpoint_mode(url: str, follow: bool, interval: float) -> int:
    while True:
        try:
            block = endpoint_status(url)
        except Exception as err:
            print(f"error: {url} unreachable: {err}", file=sys.stderr)
            return 2 if not follow else 0
        stamp = time.strftime("%H:%M:%S")
        print(f"[{stamp}] {url}")
        print(block, flush=True)
        if not follow:
            return 0
        print("-" * 72)
        try:
            time.sleep(max(0.2, interval))
        except KeyboardInterrupt:
            return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", nargs="?", help="run dir or journal.jsonl (journal mode)")
    parser.add_argument("--url", help="live /metrics endpoint base URL (endpoint mode)")
    parser.add_argument("--follow", "-f", action="store_true", help="keep watching for new rows")
    parser.add_argument("--interval", type=float, default=2.0, help="poll interval in seconds")
    args = parser.parse_args(argv)

    if bool(args.url) == bool(args.path):
        parser.error("pass exactly one of: a run path, or --url")
    if args.url:
        return run_endpoint_mode(args.url, args.follow, args.interval)
    return run_journal_mode(args.path, args.follow, args.interval)


if __name__ == "__main__":
    sys.exit(main())
