"""The port's live dashboard and cross-run diff
(``sheeprl_tpu_torch/tools/run_monitor.py``, ``health_diff.py``) against
the repo's ``tools/run_monitor.py`` and ``tools/health_diff.py`` on the same
inputs: the same text, JSON and exit codes.  ``run_monitor`` in journal
mode on a fixed journal, with ``--follow`` on one that grows, and in
endpoint mode on a stub ``/metrics`` of a training run and of a serving
one; ``health_diff`` in band, out of band, with a watched metric missing,
with ``--strict-missing``, and on bad input."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from sheeprl_tpu_torch.tools import health_diff, run_monitor
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_MONITOR, JAX_DIFF = _jax_tool("run_monitor"), _jax_tool("health_diff")


def _main(module, argv):
    """A tool's ``main`` as its command line runs it: stdout, stderr, exit code."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    sys.argv = [module.__name__, *argv]
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                code = module.main()
            except SystemExit as exit_:
                code = exit_.code
    finally:
        sys.argv = saved
    return out.getvalue(), err.getvalue(), code


def _both(port, jax, argv):
    return _main(port, argv), _main(jax, argv)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _run_events(losses, rewards, t0=1000.0, status="completed"):
    events = [{"event": "run_start", "t": t0, "algo": "ppo", "env": "discrete_dummy", "run_id": "ppo/dummy/run/version_0",
               "seed": 5, "sentinel_policy": "warn", "config_hash": "abc"},
              {"event": "state_change", "t": t0 + 0.5, "state": "compiling", "prev": "starting"},
              {"event": "telemetry_cost", "t": t0 + 1.0, "fn": "train_step", "flops_per_call": 2.0e9, "count_s": 0.2},
              {"event": "state_change", "t": t0 + 1.5, "state": "training", "prev": "compiling"}]
    for i, (loss, rew) in enumerate(zip(losses, rewards)):
        step = 16 * (i + 1)
        events.append({"event": "metrics", "t": t0 + 2 + i, "step": step, "metrics": {
            "Loss/policy_loss": loss, "Loss/value_loss": loss / 2, "Rewards/rew_avg": rew, "Telemetry/sps": 120.5,
            "Telemetry/mfu": 0.0123, "Telemetry/tflops_per_sec": 1.5, "Telemetry/env_steps_per_sec": 250.0,
            "Telemetry/phase_pct/train": 60.0, "Telemetry/phase_pct/env": 30.0, "Telemetry/goodput": 0.9,
            "Telemetry/health/grad_norm": 0.5 + i, "Telemetry/health/update_ratio": 1e-3,
            "Telemetry/health/dead_frac": 0.0, "Telemetry/hbm_bytes_in_use": 2.0e9, "Telemetry/hbm_peak_bytes": 3.0e9,
            "Telemetry/param_staleness": 0.0}})
    events += [
        {"event": "ckpt_begin", "t": t0 + 3.1, "path": "ckpt_32_0.ckpt", "step": 32, "blocking": False, "queued_s": 0.5},
        {"event": "ckpt_end", "t": t0 + 3.2, "path": "ckpt_32_0.ckpt", "step": 32, "blocking": False, "status": "ok",
         "verified": True, "bytes": 123456, "write_ms": 45.5, "queued_s": 0.5},
        {"event": "fault_injection", "t": t0 + 3.3, "iter_num": 3, "kind": "slow_write", "source": "chaos"},
        {"event": "params_reject", "t": t0 + 3.4, "reason": "nonfinite_update", "step": 48, "iter_num": 3,
         "staleness": 1, "budget": 8, "escalate": False},
        {"event": "rollback", "t": t0 + 3.5, "iter_num": 3, "step": 48, "error": "RuntimeError('x')",
         "restored_iter": 2, "retries_left": 2, "budget": 3},
        {"event": "anomaly", "t": t0 + 3.6, "kind": "entropy_collapse", "subject": "Loss/policy_loss", "step": 48},
        {"event": "divergence", "t": t0 + 3.7, "kind": "nonfinite_update", "step": 48, "nonfinite_steps": 1.0,
         "policy": "warn"},
        {"event": "stall", "t": t0 + 3.8, "since_s": 12.0},
        {"event": "stall_end", "t": t0 + 3.9, "stalled_s": 13.0},
        {"event": "preempted", "t": t0 + 4.0, "step": 64, "iter_num": 4, "path": "ckpt_64_0.ckpt", "reason": "chaos",
         "snapshot_durable": True},
        {"event": "telemetry_summary", "t": t0 + 4.1, "params_rejected": 1, "rollbacks": 1,
         "rollback_retries_left": 2, "ckpts_written": 1},
        {"event": "run_end", "t": t0 + 4.2, "status": status}]
    return events


def _write(run_dir: Path, events, name="journal.jsonl"):
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / name).write_text("".join(json.dumps(e) + "\n" for e in events))
    return run_dir


BASE_LOSS, BASE_REW = [1.0, 0.8, 0.6, 0.5, 0.45, 0.4], [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


@pytest.fixture
def runs(tmp_path):
    base = _write(tmp_path / "base", _run_events(BASE_LOSS, BASE_REW))
    green = _write(tmp_path / "green", _run_events([v * 1.03 for v in BASE_LOSS], [v * 0.98 for v in BASE_REW]))
    red = _write(tmp_path / "red", _run_events([1.0, 0.9, 1.1, 1.3, 1.5, 1.6], BASE_REW))
    fewer = [e for e in _run_events(BASE_LOSS, BASE_REW) if e["event"] != "metrics"] + [
        {"event": "metrics", "t": 1002.0 + i, "step": 16 * (i + 1), "metrics": {"Loss/policy_loss": v}}
        for i, v in enumerate(BASE_LOSS)]
    missing = _write(tmp_path / "missing", sorted(fewer, key=lambda e: e["t"]))
    return {"base": base, "green": green, "red": red, "missing": missing, "root": tmp_path}


# ---------------------------------------------------------------------------
# health_diff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, args, code", [
    ("in_band", ["base", "green"], 0),
    ("in_band_json", ["base", "green", "--json"], 0),
    ("regression", ["base", "red"], 1),
    ("regression_json", ["base", "red", "--json", "--points", "8"], 1),
    ("watch_and_tolerances", ["base", "red", "--watch", "Rewards/", "--rel-tol", "0.5", "--abs-tol", "0.1"], 0),
    ("missing", ["base", "missing"], 0),
    ("strict_missing", ["base", "missing", "--strict-missing"], 1),
    ("strict_missing_json", ["base", "missing", "--strict-missing", "--json"], 1),
    ("no_journal", ["base", "nowhere"], 2),
    ("too_few_points", ["base", "green", "--points", "1"], 2),
])
def test_health_diff_gives_the_jax_tools_output_and_exit_code(runs, case, args, code):
    argv = [str(runs[a]) if a in runs else (str(runs["root"] / a) if a == "nowhere" else a) for a in args]
    port, jax = _both(health_diff, JAX_DIFF, argv)
    assert port == jax
    assert port[2] == code
    if "--json" in args:
        assert json.loads(port[0])["failed"] is (code == 1)


def test_health_diff_library_alignment_and_missing_metrics():
    base = [{"event": "metrics", "t": i, "step": i * 10, "metrics": {"Loss/a": 1.0}} for i in range(10)]
    cand = [{"event": "metrics", "t": i, "step": i * 25, "metrics": {"Loss/a": 1.0 + 0.01 * i}} for i in range(4)]
    for kwargs in ({"watch": ("Loss/",), "points": 8}, {"watch": ("Loss/",), "points": 3, "rel_tol": 0.0, "abs_tol": 0.0}):
        assert health_diff.diff_journals(base, cand, **kwargs) == JAX_DIFF.diff_journals(base, cand, **kwargs)
    base2 = base + [{"event": "metrics", "t": 99, "step": 990, "metrics": {"Loss/b": 2.0}}]
    result = health_diff.diff_journals(base2, cand, watch=("Loss/",), points=8)
    assert result["missing_in_candidate"] == ["Loss/b"] and result["regressions"] == []
    assert health_diff.format_diff(result) == JAX_DIFF.format_diff(JAX_DIFF.diff_journals(base2, cand, ("Loss/",),
                                                                                          points=8))
    for series, points in (([(0.0, 0.0), (10.0, 10.0)], 3), ([(None, 1.0), (None, 3.0), (None, 2.0)], 5),
                           ([(4.0, 2.0)], 4), ([], 4), ([(5.0, 1.0), (5.0, 3.0)], 3)):
        assert health_diff.resample(series, points) == JAX_DIFF.resample(series, points)
    assert health_diff.compare_metric([1.0, 2.0], [1.0, 2.5], 0.1, 0.0) == JAX_DIFF.compare_metric(
        [1.0, 2.0], [1.0, 2.5], 0.1, 0.0)


# ---------------------------------------------------------------------------
# run_monitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["base", "red", "journal_file", "no_journal"])
def test_run_monitor_journal_mode_gives_the_jax_tools_view(runs, which):
    path = {"journal_file": runs["base"] / "journal.jsonl", "no_journal": runs["root"] / "nowhere"}.get(which) \
        or runs[which]
    port, jax = _both(run_monitor, JAX_MONITOR, [str(path)])
    assert port == jax
    assert port[2] == (2 if which == "no_journal" else 0)
    if which != "no_journal":
        assert "fencing 1 rejects · 1 rollbacks" in port[0] and "open: entropy_collapse" in port[0]


def test_run_monitor_usage_errors_exit_like_the_jax_tool(runs):
    for argv in ([], [str(runs["base"]), "--url", "http://127.0.0.1:9"]):
        port, jax = _both(run_monitor, JAX_MONITOR, argv)
        assert port[2] == jax[2] == 2
        assert port[1].splitlines()[-1].split(": ", 1)[-1] == jax[1].splitlines()[-1].split(": ", 1)[-1]


def _follow(module, run_dir: Path, tail_events):
    """``--follow`` on a run that is still writing: the snapshot, then each
    row as it lands, until ``run_end``."""
    journal = run_dir / "journal.jsonl"
    result = {}

    def watch():
        result["out"] = _main(module, [str(run_dir), "--follow", "--interval", "0.05"])

    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    time.sleep(0.5)
    with open(journal, "a") as fp:
        for event in tail_events:
            fp.write(json.dumps(event) + "\n")
            fp.flush()
            time.sleep(0.05)
    thread.join(timeout=30)
    assert not thread.is_alive()
    return result["out"]


def test_run_monitor_follow_streams_new_rows_until_run_end(tmp_path):
    events = _run_events(BASE_LOSS, BASE_REW)
    head, tail = events[:6], events[6:]
    got = {}
    for name, module in (("port", run_monitor), ("jax", JAX_MONITOR)):
        got[name] = _follow(module, _write(tmp_path / name, head), tail)
    assert got["port"][1:] == got["jax"][1:] and got["port"][2] == 0
    # the first line names the journal, which is the run's own; the state
    # line counts the seconds since the last write, read a second apart
    port_lines, jax_lines = ([re.sub(r"last journal write \d+s ago", "last journal write ?s ago", line)
                              for line in got[k][0].splitlines()] for k in ("port", "jax"))
    assert port_lines[1:] == jax_lines[1:]
    assert port_lines[0].endswith("port/journal.jsonl") and jax_lines[0].endswith("jax/journal.jsonl")
    assert len(port_lines) > len(tail) and "-" * 72 in port_lines


TRAINING_METRICS = """# HELP sheeprl_run_info run identity
sheeprl_run_info{run_id="ppo/dummy/run/version_0",algo="ppo",env="discrete_dummy",role="main",health_active_anomalies="entropy_collapse"} 1
sheeprl_journal_lag_seconds 3.5
sheeprl_run_state 2
sheeprl_ckpt_last_step 32
sheeprl_ckpt_age_seconds 7200
sheeprl_ckpt_interval_seconds 60
sheeprl_param_staleness 6
sheeprl_param_staleness_budget 8
sheeprl_params_rejected_total 6
sheeprl_rollbacks_total 1
sheeprl_health_anomalies 1
sheeprl_policy_steps_total 4096
sheeprl_sps 120.5
sheeprl_env_steps_per_sec 250
sheeprl_tflops_per_sec 1.25
sheeprl_mfu 0.0123
sheeprl_goodput 0.9
sheeprl_phase_pct_train 60
sheeprl_phase_pct_env 30
sheeprl_hbm_bytes_in_use 2000000000
sheeprl_hbm_peak_bytes 3000000000
sheeprl_health_grad_norm 0.5
sheeprl_recompiles_total 1
sheeprl_ckpts_written_total 3
sheeprl_restarts_total 2
"""

SERVING_METRICS = """sheeprl_run_info{run_id="serve/dv3",algo="dreamer_v3",env="dummy",role="serve",last_slow_request_id="req-7"} 1
sheeprl_serve_requests_total 120
sheeprl_serve_dispatches_total 40
sheeprl_serve_last_promote_rejected 1
sheeprl_serve_ckpt_step 64
sheeprl_serve_ckpt_step{model="default"} 64
sheeprl_serve_ckpt_step{model="canary"} 32
sheeprl_serve_requests_total{model="default"} 100
sheeprl_serve_requests_total{model="canary"} 20
sheeprl_serve_requests_per_sec 23.5
sheeprl_serve_latency_p50_ms 12.5
sheeprl_serve_latency_p99_ms 80.25
sheeprl_serve_queue_ms_p50{model="default"} 5.5
sheeprl_serve_queue_ms_p99{model="default"} 20
sheeprl_serve_dispatch_ms_p50{model="default"} 6
sheeprl_serve_slo_burn{model="default"} 1.5
sheeprl_sessions_active 8
sheeprl_sessions_capacity 8
sheeprl_sessions_created_total 9
"""


@pytest.fixture
def endpoint():
    """A stub ``/metrics``: the body served is ``endpoint.body``."""
    class Handler(BaseHTTPRequestHandler):
        body = ""

        def do_GET(self):  # noqa: N802 - stdlib API
            data = Handler.body.encode()
            self.send_response(200 if self.path == "/metrics" else 404)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield Handler, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("body", ["training", "serving"])
def test_run_monitor_endpoint_mode_gives_the_jax_tools_view(endpoint, body):
    handler, url = endpoint
    handler.body = TRAINING_METRICS if body == "training" else SERVING_METRICS
    assert run_monitor.parse_prometheus(handler.body) == JAX_MONITOR.parse_prometheus(handler.body)
    text = run_monitor.endpoint_status(url)
    assert text == JAX_MONITOR.endpoint_status(url)
    if body == "training":
        assert "!! STALE-PARAMS" in text and "!! NO-RECENT-CKPT" in text and "fencing staleness 6/8" in text
    else:
        assert "!! UNHEALTHY-CKPT" in text and "model   canary" in text
    port, jax = _both(run_monitor, JAX_MONITOR, ["--url", url])
    # the first line is the poll's wall-clock stamp
    assert port[0].splitlines()[1:] == jax[0].splitlines()[1:] and port[2] == jax[2] == 0


def test_run_monitor_endpoint_unreachable_exits_2_like_the_jax_tool():
    port, jax = _both(run_monitor, JAX_MONITOR, ["--url", "http://127.0.0.1:9"])
    assert port[2] == jax[2] == 2 and port[1].startswith("error: http://127.0.0.1:9 unreachable")


def test_run_monitor_tail_journal_matches_and_skips_partial_lines(tmp_path):
    path = tmp_path / "journal.jsonl"
    path.write_text(json.dumps({"event": "a"}) + "\n" + "not json\n" + json.dumps({"event": "b"}) + "\n{\"event\":")
    assert list(run_monitor.tail_journal(str(path), follow=False)) == \
        list(JAX_MONITOR.tail_journal(str(path), follow=False)) == [{"event": "a"}, {"event": "b"}]
