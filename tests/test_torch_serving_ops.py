"""The port's serving operations against the JAX package, on the CPU at tiny
widths: the SLO monitor and phase histograms, the ``/metrics`` text, the
health gate, atomic promotion, the checkpoint watcher, the model registry,
the request log, the serving journal and ``trace_serve.json``, and the SAC
flywheel from served traffic to offline training.

Where a piece is pure bookkeeping (``SloMonitor``, ``PhaseStats``, the
renderers, ``checkpoint_health``) both packages' classes are fed the same
inputs and must give the same outputs.  The two servers are also driven
through one scenario each with a fake policy (no model in the step) and must
journal the same event kinds with the same fields and expose the same
``/metrics`` families.  DreamerV3 is served at the tiny widths of
``tests/test_torch_dv3_serving.py``: a JAX-written newer checkpoint promoted
in the port answers with the JAX handle's greedy actions, and two models
(``default`` and ``canary``) go through promotion, the health gate, a shape
rejection, the slow-request drill and the request log over HTTP.
"""

from __future__ import annotations

import copy
import functools
import importlib.util
import io
import json
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from sheeprl_tpu.data.datasets import OfflineDataset as JaxOfflineDataset
from sheeprl_tpu.diagnostics.health import active_anomalies as jax_active_anomalies
from sheeprl_tpu.diagnostics.journal import read_journal as jax_read_journal
from sheeprl_tpu.serving import loader as jax_loader
from sheeprl_tpu.serving import registry as jax_registry
from sheeprl_tpu.serving import server as jax_server
from sheeprl_tpu.utils.checkpoint import save_state as jax_save_state
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data.datasets import OfflineDataset
from sheeprl_tpu_torch.diagnostics.report import active_anomalies
from sheeprl_tpu_torch.interop.flax_params import to_flax
from sheeprl_tpu_torch.serving import registry, server
from sheeprl_tpu_torch.serving.loader import PolicyHandle, _params_loader, checkpoint_health, leaf_dtype_mismatch
from sheeprl_tpu_torch.serving.request_log import RequestLog
from sheeprl_tpu_torch.serving.server import CheckpointWatcher, PhaseStats, PolicyService, ServeApp, SloMonitor
from sheeprl_tpu_torch.utils.checkpoint import save_state
from test_torch_dv3_serving import (  # noqa: F401  (tiny: the module-scoped JAX/port DV3 pair)
    ACTIONS_DIM,
    TINY,
    _margins_hold,
    _obs_np,
    _port_noise,
    _torch,
    tiny,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO_ROOT = Path(__file__).resolve().parents[1]


class Journal:
    """Captures ``RunJournal.write`` calls as plain dicts."""

    def __init__(self):
        self.events = []

    def write(self, kind, **fields):
        self.events.append({"event": kind, **fields})

    def sync(self):
        pass


def _wait_for(predicate, timeout_s: float = 20.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _post(url, payload, headers=None, path="/act"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(), headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}"), dict(err.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return resp.read().decode()


def _families(metrics_text: str) -> set:
    return {line.split()[2] for line in metrics_text.splitlines() if line.startswith("# TYPE ")}


# ---------------------------------------------------------------------------
# the bookkeeping, fed the same inputs in both packages
# ---------------------------------------------------------------------------

SLO_SEQUENCES = {
    "breach_then_recover": [1.0] * 4 + [300.0] * 6 + [1.0] * 12,
    "flapping": [300.0, 1.0] * 10,
    "never_breaches": [1.0, 2.0, 3.0] * 6,
    "long_breach": [300.0] * 20 + [1.0] * 40,
}


@pytest.mark.parametrize("name", sorted(SLO_SEQUENCES))
def test_slo_monitor_burn_and_journal_match_jax(name):
    kwargs = dict(target_ms=100.0, objective=0.8, window=8, confirm=2, model="m")
    mine, theirs = Journal(), Journal()
    port, ref = SloMonitor(journal=mine, **kwargs), jax_server.SloMonitor(journal=theirs, **kwargs)
    for value in SLO_SEQUENCES[name]:
        assert port.observe(value) == ref.observe(value)
        assert (port.active, port.breaches_total) == (ref.active, ref.breaches_total)

    def timeless(events):
        return [{k: v for k, v in e.items() if k != "breach_s"} for e in events]

    assert timeless(mine.events) == timeless(theirs.events)
    assert [set(e) for e in mine.events] == [set(e) for e in theirs.events]


def test_slo_monitor_without_a_target_is_off_in_both():
    assert SloMonitor().observe(1e6) == jax_server.SloMonitor().observe(1e6) == 0.0
    assert not SloMonitor().enabled and not jax_server.SloMonitor().enabled


@pytest.mark.parametrize("buckets", [None, [0.5, 5.0, 50.0]])
def test_phase_stats_percentiles_and_histograms_match_jax(buckets):
    rng = np.random.default_rng(0)
    port, ref = PhaseStats(buckets), jax_server.PhaseStats(buckets)
    for _ in range(1500):  # past the rolling window's 1024
        phase = PhaseStats.PHASES[int(rng.integers(0, 5))]
        value = float(rng.lognormal(1.0, 1.5)) * (1 if rng.random() > 0.01 else -1)
        port.observe(phase, value)
        ref.observe(phase, value)
    assert port.percentiles() == ref.percentiles()
    assert port.histogram() == ref.histogram()
    with pytest.raises(ValueError, match="ascending"):
        PhaseStats([5.0, 1.0])


def _snapshot(seed: int, stateful: bool) -> dict:
    rng = np.random.default_rng(seed)
    stats = PhaseStats()
    for phase in PhaseStats.PHASES:
        for _ in range(20):
            stats.observe(phase, float(rng.lognormal(1.0, 1.0)))
    gauges = {"Telemetry/serve/queue_depth": int(rng.integers(0, 9)), "Telemetry/serve/ckpt_step": 64 + seed,
              "Telemetry/serve/last_promote_rejected": seed % 2, "Telemetry/serve/latency_p99_ms": 3.25 + seed,
              "Telemetry/serve/dispatch_ms_p50": 0.5 * seed, "Telemetry/serve/slo_burn": 0.125}
    counters = {"serve_requests_total": 40 + seed, "serve_dispatches_total": 9, "serve_request_errors_total": 1,
                "serve_ckpt_promotions_total": seed, "serve_slow_requests_total": 2}
    if stateful:
        gauges["Telemetry/sessions/active"] = 3
        counters["sessions_evictions_total"] = 5
    return {"info": {"algo": "dreamer_v3", "role": "serve", "model": f"m{seed}"}, "gauges": gauges,
            "counters": counters, "batch_width_hist": {2: 5 + seed, 8: 4}, "latency_hist": stats.histogram()}


@pytest.mark.parametrize("stateful", [False, True])
def test_render_serving_metrics_matches_jax(stateful):
    snap = _snapshot(1, stateful)
    assert server.render_serving_metrics(snap) == jax_server.render_serving_metrics(snap)


class _Snap:
    def __init__(self, snap):
        self._snap = snap

    def snapshot(self):
        return copy.deepcopy(self._snap)


@pytest.mark.parametrize("n_models", [1, 3])
def test_render_registry_metrics_matches_jax(n_models):
    port, ref = registry.ModelRegistry(), jax_registry.ModelRegistry()
    for i in range(n_models):
        name = "default" if i == 0 else f"canary{i}"
        snap = _Snap(_snapshot(i, stateful=i % 2 == 0))
        port.add(registry.ModelEntry(name=name, service=snap, handle=None), default=i == 0)
        ref.add(jax_registry.ModelEntry(name=name, service=snap, handle=None), default=i == 0)
    text = registry.render_registry_metrics(port)
    assert text == jax_registry.render_registry_metrics(ref)
    assert text.count("# TYPE sheeprl_serve_latency_ms histogram") == 1


def _training_journal(version: Path, lines) -> None:
    with open(version / "journal.jsonl", "a", encoding="utf-8") as fp:
        for line in lines:
            fp.write(json.dumps(line) + "\n")


ANOMALY = {"t": 1.0, "event": "anomaly", "kind": "entropy_collapse", "subject": "Loss/entropy_loss", "step": 40}
ANOMALY_END = {"t": 2.0, "event": "anomaly_end", "kind": "entropy_collapse", "subject": "Loss/entropy_loss"}
HEALTH_CASES = {
    "open_anomaly": ([{"t": 0.5, "event": "metrics"}, ANOMALY], {}),
    "closed_anomaly": ([ANOMALY, ANOMALY_END], {}),
    "no_journal": (None, {}),
    "no_journal_not_allowed": (None, {"allow_unjournaled": False}),
    "gate_off": ([ANOMALY], {"health_gate": False}),
}


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_checkpoint_health_verdicts_match_jax(tmp_path, case):
    lines, kwargs = HEALTH_CASES[case]
    version = tmp_path / "version_0"
    (version / "checkpoint").mkdir(parents=True)
    ckpt = version / "checkpoint" / "ckpt_8_0.ckpt"
    save_state(str(ckpt), {"agent": {"w": np.ones(1, np.float32)}})
    if lines is not None:
        _training_journal(version, lines)
    verdict = checkpoint_health(str(ckpt), **kwargs)
    assert verdict == jax_loader.checkpoint_health(str(ckpt), **kwargs)
    assert verdict[0] is (case in ("closed_anomaly", "no_journal", "gate_off"))
    events = jax_read_journal(str(version / "journal.jsonl")) if lines is not None else []
    assert active_anomalies(events) == jax_active_anomalies(events)


# ---------------------------------------------------------------------------
# promotion and the watcher, with a fake policy: its action reveals WHICH
# weights served it and THAT its own row was used
# ---------------------------------------------------------------------------


class _Scalar(torch.nn.Module):
    def __init__(self, w: float, n: int = 1, dtype=torch.float32):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((n,), float(w), dtype=dtype))


def _build_scalar(state) -> _Scalar:
    w = np.asarray(state["w"])
    if w.shape != (1,):
        raise ValueError(f"flax param '/w' maps to shape {w.shape}, the port has (1,)")
    module = _Scalar(0.0)
    with torch.no_grad():
        module.w.copy_(torch.from_numpy(w))
    return module


def _fake_handle(w: float = 1.0, stateful: bool = False, ckpt_path: str = "", ckpt_step: int = 0) -> PolicyHandle:
    obs_spec = {"state": ((4,), "float32")}

    def assemble(rows, width):
        buf = np.zeros((int(width), 4), np.float32)
        for i, row in enumerate(rows):
            buf[i] = row["state"]
        return {"state": buf}

    def validate(obs):
        if not isinstance(obs, dict) or "state" not in obs:
            raise ValueError("obs must be a dict with a 'state' key")
        arr = np.asarray(obs["state"], np.float32).reshape(-1)
        if arr.size != 4:
            raise ValueError("state must have 4 elements")
        return {"state": arr}

    def make_step(greedy):
        @torch.no_grad()
        def step(p, obs, generator, noise=None):
            x = obs["state"]
            return torch.cat([p.w[:1].expand(x.shape[0], 1), x.sum(-1, keepdim=True)], dim=-1)

        return step

    def make_state_step(greedy):
        @torch.no_grad()
        def step(p, state, obs, is_first, generator, noise=None):
            count = state["count"] * (1.0 - is_first) + 1.0
            x = obs["state"]
            return torch.cat([p.w[:1].expand(x.shape[0], 1), count, x.sum(-1, keepdim=True)], -1), {"count": count}

        return step

    return PolicyHandle(
        algo="fake_recurrent" if stateful else "fake",
        obs_spec=obs_spec,
        action_shape=(3,) if stateful else (2,),
        params=_Scalar(w),
        assemble=assemble,
        validate=validate,
        device=torch.device("cpu"),
        ckpt_path=ckpt_path,
        ckpt_step=ckpt_step,
        meta={"is_continuous": False, "actions_dim": [3]},
        stateful=stateful,
        state_spec={"count": ((1,), "float32")} if stateful else {},
        make_state_step=make_state_step if stateful else None,
        make_step=None if stateful else make_step,
        load_params=_params_loader(_build_scalar, "cpu"),
    )


def test_promotion_during_an_inflight_batch_mixes_nothing_and_drops_nothing():
    svc = PolicyService(_fake_handle(), {"batch_buckets": [2], "max_delay_ms": 5.0})
    svc._step_delay_s = 0.25  # snapshot, then sleep: the promotion lands in the gap
    svc.start()
    results, lock = [], threading.Lock()
    old = svc._params

    def client(i):
        r = svc.act({"state": np.full(4, i, np.float32)}, timeout_s=10.0)
        with lock:
            results.append(r)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads[:2]:
            t.start()
        _wait_for(lambda: svc._dispatch_counter > 0, what="the first dispatch")
        time.sleep(0.05)
        for t in threads[2:]:
            t.start()
        new = _Scalar(2.0)
        assert svc.promote(new, 99, "/x/ckpt_99_0.ckpt")
        assert svc.handle.params is new and old.w.item() == 1.0  # new modules; the live ones untouched
        for t in threads:
            t.join(timeout=10)
    finally:
        svc.close()
    assert len(results) == 6
    by_dispatch = {}
    for r in results:
        by_dispatch.setdefault(r["dispatch_id"], []).append(r)
    for rows in by_dispatch.values():
        assert len({float(r["action"][0]) for r in rows}) == 1 and len({r["params_version"] for r in rows}) == 1
    assert {float(r["action"][0]) for r in results} == {1.0, 2.0}
    for r in results:
        assert float(r["action"][0]) == (1.0 if r["params_version"] == 0 else 2.0)
        assert float(r["action"][1]) in {4.0 * i for i in range(6)}  # its own row's sum


@pytest.mark.parametrize("bad", ["shape", "keys", "dtype", "not_a_module"])
def test_promote_rejects_a_mismatched_tree_and_the_old_weights_keep_serving(bad):
    journal = Journal()
    svc = PolicyService(_fake_handle(), {"batch_buckets": [2]}, journal=journal, model="m")
    svc.start()
    candidate = {
        "shape": _Scalar(5.0, n=3),
        "keys": torch.nn.Linear(1, 1),
        "dtype": _Scalar(5.0, dtype=torch.float64),
        "not_a_module": {"w": np.float32(5.0)},
    }[bad]
    try:
        assert not svc.promote(candidate, 5, "bad_ckpt_5_0.ckpt")
        assert svc.rejections_total == 1 and svc.last_promote_rejected and svc.ckpt_step == 0
        assert float(svc.act({"state": [0, 0, 0, 0]})["action"][0]) == 1.0
        assert svc.promote(_Scalar(3.0), 6, "good_ckpt_6_0.ckpt")
        assert not svc.last_promote_rejected and float(svc.act({"state": [0, 0, 0, 0]})["action"][0]) == 3.0
    finally:
        svc.close()
    (reject,) = [e for e in journal.events if e["event"] == "ckpt_reject"]
    assert reject["reason"].startswith("param tree mismatch") and reject["step"] == 5 and reject["model"] == "m"


def test_sessions_survive_a_promotion():
    svc = PolicyService(_fake_handle(stateful=True), {"batch_buckets": [2], "sessions": {"capacity": 2}})
    svc.start()
    try:
        counts = [svc.act({"state": [1, 1, 1, 1]}, session="s")["action"] for _ in range(2)]
        assert svc.promote(_Scalar(7.0), 3, "ckpt_3_0.ckpt")
        after = svc.act({"state": [1, 1, 1, 1]}, session="s")["action"]
    finally:
        svc.close()
    assert [float(a[1]) for a in counts] == [1.0, 2.0]
    assert float(after[0]) == 7.0 and float(after[1]) == 3.0


def _run_dir(tmp_path: Path) -> Path:
    version = tmp_path / "version_0"
    (version / "checkpoint").mkdir(parents=True)
    return version


def _write_ckpt(version: Path, step: int, w, name=None) -> str:
    path = version / "checkpoint" / (name or f"ckpt_{step}_0.ckpt")
    save_state(str(path), {"agent": {"w": np.asarray(w)}})
    return str(path)


def test_watcher_promotes_retries_an_anomalous_checkpoint_and_rejects_a_shape_change(tmp_path):
    version = _run_dir(tmp_path)
    first = _write_ckpt(version, 4, np.ones(1, np.float32))
    _training_journal(version, [{"t": 0.1, "event": "metrics", "step": 4}])
    journal = Journal()
    svc = PolicyService(_fake_handle(ckpt_path=first, ckpt_step=4), {"batch_buckets": [2]}, journal=journal,
                        model="default")
    svc.start()
    watcher = CheckpointWatcher(svc, str(version / "checkpoint"), journal=journal)
    try:
        assert watcher.check_once() is None  # nothing newer
        _write_ckpt(version, 8, np.full(1, 2.0, np.float32))
        assert watcher.check_once() is True and svc.ckpt_step == 8
        assert float(svc.act({"state": [0, 0, 0, 0]})["action"][0]) == 2.0
        _training_journal(version, [ANOMALY])
        _write_ckpt(version, 12, np.full(1, 3.0, np.float32))
        assert watcher.check_once() is False  # journaled once...
        assert watcher.check_once() is None  # ...then retried quietly
        _training_journal(version, [ANOMALY_END])
        assert watcher.check_once() is True and svc.ckpt_step == 12
        _write_ckpt(version, 16, np.zeros(3, np.float32))  # another shape
        assert watcher.check_once() is False and watcher.check_once() is None  # permanent
        _write_ckpt(version, 20, np.ones(1, np.float64))  # another dtype
        assert watcher.check_once() is False and watcher.check_once() is None
        assert svc.ckpt_step == 12 and float(svc.act({"state": [0, 0, 0, 0]})["action"][0]) == 3.0
    finally:
        svc.close()
    kinds = [(e["event"], e["step"]) for e in journal.events if e["event"].startswith("ckpt_")]
    assert kinds == [("ckpt_promote", 8), ("ckpt_reject", 12), ("ckpt_promote", 12), ("ckpt_reject", 16),
                     ("ckpt_reject", 20)]
    rejects = [e for e in journal.events if e["event"] == "ckpt_reject"]
    assert rejects[0]["anomalies"] == [{"kind": "entropy_collapse", "subject": "Loss/entropy_loss", "step": 40}]
    assert "shape" in rejects[1]["reason"] and "dtype float64" in rejects[2]["reason"]
    assert leaf_dtype_mismatch({"a": {"b": np.zeros(2, np.float16)}}) == "/a/b dtype float16 -> float32"


def test_watcher_orders_foreign_names_by_mtime(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    svc = PolicyService(_fake_handle(), {"batch_buckets": [2]})
    svc.start()
    watcher = CheckpointWatcher(svc, str(models), allow_unjournaled=True)
    try:
        foreign = models / "actor.ckpt"
        save_state(str(foreign), {"agent": {"w": np.full(1, 7.0, np.float32)}})
        assert watcher.check_once() is True and watcher.check_once() is None
        assert float(svc.act({"state": [0, 0, 0, 0]})["action"][0]) == 7.0
        time.sleep(0.05)
        save_state(str(foreign), {"agent": {"w": np.full(1, 8.0, np.float32)}})
        os.utime(foreign, (time.time() + 1, time.time() + 1))
        assert watcher.check_once() is True
        assert float(svc.act({"state": [0, 0, 0, 0]})["action"][0]) == 8.0
    finally:
        svc.close()


def test_inject_slow_iter_needs_slow_trace_ms():
    with pytest.raises(ValueError, match="slow_trace_ms"):
        PolicyService(_fake_handle(), {"batch_buckets": [2]}, inject_slow_iter=1)


# ---------------------------------------------------------------------------
# both servers through one scenario: the journal's kinds and fields, the
# /metrics families
# ---------------------------------------------------------------------------


def _jax_fake_handle(ckpt_path: str, ckpt_step: int) -> jax_loader.PolicyHandle:
    spec = importlib.util.spec_from_file_location("jax_serving_fakes", REPO_ROOT / "tests/test_serving/conftest.py")
    fakes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fakes)
    handle = fakes.make_fake_stateful_handle()
    # the port's fake keeps its weight as a [1] tensor, this one as a scalar
    handle.load_params = lambda state: {"w": np.asarray(state["w"], np.float32).reshape(
        () if np.size(state["w"]) == 1 else np.shape(state["w"]))}
    handle.ckpt_path, handle.ckpt_step = ckpt_path, ckpt_step
    return handle


SCENARIO_SERVING = {
    "batch_buckets": [2],
    "max_delay_ms": 1.0,
    "sessions": {"capacity": 1},
    "reload": {"enabled": True, "poll_s": 0.05},
    "journal_every_s": 0.05,
    "slo": {"target_ms": 100.0, "objective": 0.5, "window": 8, "confirm": 1, "slow_trace_ms": 100.0},
    "request_log": {"enabled": True, "rotate_rows": 2},
    "trace": {"enabled": True},
}


def _scenario(app, save, version: Path) -> tuple:
    """Drive one app: the slow-request drill, a session eviction, SLO
    recovery, a promotion, a health-gate rejection then promotion, a shape
    rejection; returns (/metrics text, journal events)."""
    host, port = app.start()
    url = f"http://{host}:{port}"
    service = app.service
    status, body, headers = _post(url, {"obs": {"state": [1, 2, 3, 4]}, "session": "a"}, {"X-Request-Id": "slow-1"})
    assert status == 200 and headers["X-Request-Id"] == "slow-1"
    _wait_for(lambda: service.slow_requests_total == 1 and service.slo.active, what="the slow request")
    for sid in ("b", "a", None, None):
        assert _post(url, {"obs": {"state": [0, 0, 0, 1]}, "session": sid})[0] == 200
    # under load a request can itself miss the 100 ms target and keep the
    # window breached: feed the window until the SLO recovers
    deadline = time.monotonic() + 20.0
    while service.slo.active:
        assert time.monotonic() < deadline, "timed out waiting for SLO recovery"
        assert _post(url, {"obs": {"state": [0, 0, 0, 1]}})[0] == 200
        time.sleep(0.01)
    ckpt_dir = version / "checkpoint"
    save(str(ckpt_dir / "ckpt_5_0.ckpt"), {"agent": {"w": np.full(1, 2.0, np.float32)}})
    _wait_for(lambda: service.ckpt_step == 5, what="the promotion")
    _training_journal(version, [ANOMALY])
    save(str(ckpt_dir / "ckpt_6_0.ckpt"), {"agent": {"w": np.full(1, 3.0, np.float32)}})
    _wait_for(lambda: service.rejections_total == 1, what="the health-gate rejection")
    _training_journal(version, [ANOMALY_END])
    _wait_for(lambda: service.ckpt_step == 6, what="the promotion after anomaly_end")
    save(str(ckpt_dir / "ckpt_7_0.ckpt"), {"agent": {"w": np.zeros(3, np.float32)}})
    _wait_for(lambda: service.rejections_total == 2, what="the shape rejection")
    assert _post(url, {"obs": {"state": [0, 0, 0, 1]}})[0] == 200
    # a metrics heartbeat after the last request
    total = service.batcher.stats()["requests_total"]
    journal = os.path.join(app.log_dir, "journal.jsonl")
    _wait_for(lambda: any(e["event"] == "metrics" and e.get("step") == total for e in jax_read_journal(journal)),
              what="a metrics heartbeat after the last request")
    metrics = _get(url, "/metrics")
    app.close()
    return metrics, jax_read_journal(os.path.join(app.log_dir, "journal.jsonl"))


def test_both_servers_journal_the_same_kinds_and_fields_and_expose_the_same_families(tmp_path, monkeypatch):
    results = {}
    for package in ("jax", "port"):
        root = tmp_path / package
        version = _run_dir(root)
        first = version / "checkpoint" / "ckpt_4_0.ckpt"
        _training_journal(version, [{"t": 0.1, "event": "metrics", "step": 4}])
        monkeypatch.chdir(root)
        cfg = {"run_name": "ops", "env": {"id": "fake"}, "serving": copy.deepcopy(SCENARIO_SERVING),
               "diagnostics": {"serving": {"inject_slow_iter": 1}}}
        if package == "jax":
            jax_save_state(str(first), {"agent": {"w": np.ones(1, np.float32)}})
            monkeypatch.setattr(jax_server, "load_policy", lambda cfg, path: _jax_fake_handle(path, 4))
            monkeypatch.setattr(jax_server, "PolicyService", functools.partial(jax_server.PolicyService, aot=False))
            app, save = jax_server.ServeApp(cfg, str(first)), jax_save_state
        else:
            save_state(str(first), {"agent": {"w": np.ones(1, np.float32)}})
            monkeypatch.setattr(server, "load_policy",
                                lambda cfg, path, device: _fake_handle(stateful=True, ckpt_path=path, ckpt_step=4))
            app, save = ServeApp(cfg, str(first), "cpu"), save_state
        results[package] = _scenario(app, save, version)
    (jax_metrics, jax_events), (metrics, events) = results["jax"], results["port"]
    assert _families(metrics) == _families(jax_metrics)

    def fields(evs):
        out = {}
        for e in evs:
            out.setdefault(e["event"], set()).update(k for k in e if k != "t")
        return out

    assert fields(events) == fields(jax_events)
    assert set(fields(events)) >= {"serve_start", "metrics", "session_evict", "ckpt_promote", "ckpt_reject",
                                   "slo_breach", "slo_breach_end", "slow_request", "request_log_rotate",
                                   "fault_injection", "run_end"}
    gauges = [set(e["metrics"]) for e in events if e["event"] == "metrics"][-1]
    assert gauges == [set(e["metrics"]) for e in jax_events if e["event"] == "metrics"][-1]
    for evs in (events, jax_events):
        steps = [(e["event"], e["step"]) for e in evs if e["event"] in ("ckpt_promote", "ckpt_reject")]
        assert steps == [("ckpt_promote", 5), ("ckpt_reject", 6), ("ckpt_promote", 6), ("ckpt_reject", 7)]
        assert evs[-1]["event"] == "run_end" and evs[-1]["status"] == "completed"


# ---------------------------------------------------------------------------
# the request log
# ---------------------------------------------------------------------------


def test_request_log_shards_open_in_the_jax_dataset_with_the_same_rows(tmp_path):
    journal = Journal()
    log = RequestLog(str(tmp_path / "requests" / "m"), _fake_handle(stateful=True), model="m", rotate_rows=3,
                     journal=journal)
    rng = np.random.default_rng(0)
    for _ in range(5):
        rows = [{"state": rng.normal(size=4).astype(np.float32)} for _ in range(2)]
        log.append(rows, rng.normal(size=(2, 3)).astype(np.float32), np.asarray([[1.0], [0.0]], np.float32))
    log.close()
    assert log.stats() == {"rows_total": 10, "shards_total": 3, "dropped_total": 0, "buffered": 0}
    port, ref = OfflineDataset(log.root), JaxOfflineDataset(log.root)
    assert port.total_rows == ref.total_rows == 10 and not port.skipped and not ref.skipped
    steps = list(range(10))
    mine, theirs = port.gather(0, steps), ref.gather(0, steps)
    assert sorted(mine) == sorted(theirs) == ["actions", "is_first", "rewards", "state", "terminated"]
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    np.testing.assert_array_equal(mine["is_first"][:, 0], [1, 0] * 5)
    assert ref.meta["meta"]["algo"] == "fake_recurrent" and ref.meta["meta"]["actions_dim"] == [3]
    assert [e["rows"] for e in journal.events if e["event"] == "request_log_rotate"] == [4, 4, 2]


def test_a_full_request_log_queue_sheds(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.serving import request_log

    gate = threading.Event()
    real = request_log.write_shard

    def blocked(*args, **kwargs):
        gate.wait(10)
        return real(*args, **kwargs)

    monkeypatch.setattr(request_log, "write_shard", blocked)
    journal = Journal()
    log = RequestLog(str(tmp_path / "r"), _fake_handle(), model="m", rotate_rows=1, journal=journal)
    log.append([{"state": np.zeros(4, np.float32)}], np.zeros((1, 2), np.float32))
    _wait_for(lambda: log._queue.empty(), what="the writer to take the first shard")
    for i in range(request_log.MAX_PENDING_SHARDS + 2):  # the queue fills, two are shed
        log.append([{"state": np.full(4, i, np.float32)}], np.zeros((1, 2), np.float32))
    gate.set()
    log.close()
    stats = log.stats()
    assert stats["dropped_total"] == 2 and stats["rows_total"] == request_log.MAX_PENDING_SHARDS + 3
    assert stats["shards_total"] == request_log.MAX_PENDING_SHARDS + 1
    dropped = [e for e in journal.events if e.get("dropped")]
    assert len(dropped) == 2 and all(e["rows"] == 1 and e["model"] == "m" for e in dropped)


def test_a_failed_shard_write_is_raised_not_swallowed(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.serving import request_log

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(request_log, "write_shard", broken)
    log = RequestLog(str(tmp_path / "r"), _fake_handle(), rotate_rows=1)
    log.append([{"state": np.zeros(4, np.float32)}], np.zeros((1, 2), np.float32))
    with pytest.raises(RuntimeError, match="shard write failed"):
        log.close()


# ---------------------------------------------------------------------------
# DreamerV3 at tiny widths: a JAX-written checkpoint promoted in the port
# ---------------------------------------------------------------------------


def _tiny_run(tmp_path: Path, cfg, name: str, step: int, agent_state) -> Path:
    version = tmp_path / name / "version_0"
    (version / "checkpoint").mkdir(parents=True)
    with open(version / "config.yaml", "w") as fp:
        yaml.safe_dump(cfg.as_dict(), fp)
    ckpt = version / "checkpoint" / f"ckpt_{step}_0.ckpt"
    save_state(str(ckpt), agent_state)
    return ckpt


def _other_params(tiny, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype), tiny["params"])


def test_a_jax_written_checkpoint_promoted_in_the_port_answers_as_the_jax_handle(tiny, tmp_path):
    ckpt = _tiny_run(tmp_path, tiny["cfg"], "run", 8, to_flax(*tiny["agent"]))
    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu",
                                               "serving.batch_buckets=[4]", "serving.reload.enabled=False"])
    app = ServeApp(cfg, ckpt_path, device)
    try:
        service, handle = app.service, app.handle
        old = service._params
        old_weights = {k: v.clone() for k, v in server.params_state(old).items()}
        newer = _other_params(tiny, 11)
        jax_save_state(str(ckpt.parent / "ckpt_64_0.ckpt"), newer)  # the JAX package writes it
        watcher = CheckpointWatcher(service, str(ckpt.parent))
        assert watcher.check_once() is True and service.ckpt_step == 64
        params, version, step = service._snapshot_params()
        assert params is handle.params and params is not old and (version, step) == (1, 64)
        batch = 3
        obs = _obs_np(batch, seed=60)
        is_first = np.asarray([[1.0], [1.0], [0.0]], np.float32)
        jstate = {k: np.zeros((batch,) + shape, dtype) for k, (shape, dtype) in handle.state_spec.items()}
        jstate["recurrent"] = np.random.default_rng(1).normal(size=jstate["recurrent"].shape).astype(np.float32)
        key = jax.random.PRNGKey(4)
        want, want_state = tiny["jax_steps"][True](newer, jstate, obs, is_first, key)
        noise = _port_noise(key, batch, True)
        # the service's own slab step (the one its dispatches run) on the promoted modules
        slab = {k: torch.from_numpy(v) for k, v in jstate.items()}
        idx = torch.arange(batch)
        got = _margins_hold(handle, lambda: service._step(4, True)(params, slab, idx, _torch(obs),
                                                                  torch.from_numpy(is_first), None, noise), noise)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        np.testing.assert_allclose(slab["recurrent"].numpy(), np.asarray(want_state["recurrent"]), atol=1e-5, rtol=0)
        # the old modules were left as they were: nothing was written in place
        for k, v in server.params_state(old).items():
            torch.testing.assert_close(v, old_weights[k], rtol=0, atol=0)
    finally:
        app.close()


# ---------------------------------------------------------------------------
# DreamerV3 at tiny widths: two models over HTTP, the whole operations layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tiny, tmp_path_factory):
    """One serving run of two models (``default`` and a ``canary`` copy of
    its run) with reload, trace, the SLO drill and the request log on; what
    it saw is returned for the tests below."""
    root = tmp_path_factory.mktemp("serve_ops")
    cfg = tiny["cfg"]
    ckpt = _tiny_run(root, cfg, "default_run", 8, to_flax(*tiny["agent"]))
    version = ckpt.parent.parent
    _training_journal(version, [{"t": 0.1, "event": "metrics", "step": 8}])
    canary_version = root / "canary_run" / "version_0"
    shutil.copytree(version, canary_version)
    canary_ckpt = canary_version / "checkpoint" / ckpt.name
    cwd = os.getcwd()
    os.chdir(root)  # logs/serve/... goes under the test's directory
    try:
        serve_cfg, ckpt_path, device = cli.serve_config([
            f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serving.batch_buckets=[2,4]",
            "serving.max_delay_ms=2.0", "serving.sessions.capacity=8", "serving.reload.poll_s=0.05",
            "serving.slo.target_ms=400.0", "serving.slo.objective=0.5", "serving.slo.window=8", "serving.slo.confirm=1",
            "serving.slo.slow_trace_ms=400.0", "diagnostics.serving.inject_slow_iter=1",
            "serving.request_log.enabled=True", "serving.request_log.rotate_rows=3",
            f"serving.models={{canary: {canary_ckpt}}}",
        ])
        app = ServeApp(serve_cfg, ckpt_path, device)
    finally:
        os.chdir(cwd)
    seen = {"replies": [], "errors": {}, "app": app}
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        default, canary = app.registry.get("default").service, app.registry.get("canary").service
        obs = {k: v[0].tolist() for k, v in _obs_np(1, seed=70).items()}
        seen["replies"].append(("default", *_post(url, {"obs": obs, "session": "d0"}, {"X-Request-Id": "req-slow"})))
        _wait_for(lambda: default.slow_requests_total == 1, what="the slow request")

        def client(model, sid):
            for j in range(3):
                rid = f"{model}-{sid}-{j}"
                status, body, headers = _post(url, {"obs": obs, "session": sid, "model": model, "greedy": j != 1},
                                              {"X-Request-Id": rid})
                seen["replies"].append((model, status, body, headers))

        threads = [threading.Thread(target=client, args=(m, f"{m}{i}")) for m in ("default", "canary")
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        _wait_for(lambda: not default.slo.active, what="SLO recovery")
        # every reply path carries the X-Request-Id
        seen["errors"]["400"] = _post(url, {"obs": {"rgb": [1]}}, {"X-Request-Id": "bad-obs"})
        seen["errors"]["404_model"] = _post(url, {"obs": obs, "model": "nope"}, {"X-Request-Id": "bad-model"})
        seen["errors"]["404_path"] = _post(url, {"obs": obs}, {"X-Request-Id": "bad-path"}, path="/nope")
        real = canary.handle.assemble

        def broken(rows, width):
            raise RuntimeError("injected")

        canary.handle.assemble = broken
        seen["errors"]["500"] = _post(url, {"obs": obs, "model": "canary"}, {"X-Request-Id": "bad-dispatch"})
        canary.handle.assemble = real
        seen["errors"]["generated"] = _post(url, {"obs": obs})
        seen["replies"].append(("default", *seen["errors"]["generated"]))

        # promotion: newer weights from another seed into default's watch dir
        newer = to_flax(*build_agent(ACTIONS_DIM, False, compose(TINY + ["seed=9"]), tiny["obs_space"], None, "cpu"))
        save_state(str(ckpt.parent / "ckpt_16_0.ckpt"), newer)
        _wait_for(lambda: default.ckpt_step == 16, what="the promotion")
        seen["healthz_after_promote"] = json.loads(_get(url, "/healthz"))
        for model in ("default", "canary"):
            seen["replies"].append((model, *_post(url, {"obs": obs, "model": model})))
        seen["after_promote"] = {m: seen["replies"][-i][2] for m, i in (("default", 2), ("canary", 1))}
        # the health gate: rejected while the anomaly is open, promoted after anomaly_end
        _training_journal(version, [ANOMALY])
        save_state(str(ckpt.parent / "ckpt_24_0.ckpt"), newer)
        _wait_for(lambda: default.rejections_total == 1, what="the health-gate rejection")
        time.sleep(0.2)  # a few more polls: still rejected, journaled once
        seen["step_while_open"] = default.ckpt_step
        _training_journal(version, [ANOMALY_END])
        _wait_for(lambda: default.ckpt_step == 24, what="the promotion after anomaly_end")
        # a checkpoint at another recurrent size: rejected for good
        wide = compose(TINY + ["algo.world_model.recurrent_model.recurrent_state_size=16"])
        save_state(str(ckpt.parent / "ckpt_32_0.ckpt"),
                   to_flax(*build_agent(ACTIONS_DIM, False, wide, tiny["obs_space"], None, "cpu")))
        _wait_for(lambda: default.rejections_total == 2, what="the shape rejection")
        time.sleep(0.2)
        seen["replies"].append(("default", *_post(url, {"obs": obs, "session": "d0"})))
        seen["metrics"] = _get(url, "/metrics")
        seen["healthz"] = json.loads(_get(url, "/healthz"))
        seen["steps"] = {m: app.registry.get(m).service.ckpt_step for m in ("default", "canary")}
        seen["rejections"] = default.rejections_total
        seen["permanent"] = set(app.watcher._rejected_permanent)
    finally:
        app.close()
    seen["journal"] = jax_read_journal(os.path.join(app.log_dir, "journal.jsonl"))
    seen["trace"] = json.loads((Path(app.log_dir) / "trace_serve.json").read_text())
    return seen


def test_served_models_answer_every_request_with_its_request_id(served):
    replies = served["replies"]
    assert len(replies) == 1 + 12 + 1 + 2 + 1 and all(status == 200 for _, status, _, _ in replies)
    for model, _, body, headers in replies:
        assert headers["X-Request-Id"] == body["request_id"]
        action = np.asarray(body["action"])
        assert action.shape == (sum(ACTIONS_DIM),) and np.allclose(action[:2].sum(), 1.0)
    named = [(h["X-Request-Id"], m) for m, _, _, h in replies if "-" in h["X-Request-Id"]]
    assert sum(1 for rid, m in named if rid.startswith(m + "-")) == 12
    errors = served["errors"]
    for case, rid, status in (("400", "bad-obs", 400), ("404_model", "bad-model", 404), ("404_path", "bad-path", 404),
                              ("500", "bad-dispatch", 500)):
        assert errors[case][0] == status and errors[case][2]["X-Request-Id"] == rid, case
    assert "canary" in errors["404_model"][1]["error"] and "injected" in errors["500"][1]["error"]
    assert len(errors["generated"][2]["X-Request-Id"]) == 16


def test_served_models_promote_gate_and_reject_independently(served):
    assert served["healthz_after_promote"]["models"]["default"]["ckpt_step"] == 16
    assert served["healthz_after_promote"]["models"]["canary"]["ckpt_step"] == 8
    after = served["after_promote"]
    assert (after["default"]["ckpt_step"], after["default"]["params_version"]) == (16, 1)
    assert (after["canary"]["ckpt_step"], after["canary"]["params_version"]) == (8, 0)
    assert served["step_while_open"] == 16 and served["steps"] == {"default": 24, "canary": 8}
    assert served["rejections"] == 2 and len(served["permanent"]) == 1
    assert served["healthz"]["status"] == "ok" and served["healthz"]["last_promote_rejected"] is True
    events = served["journal"]
    decisions = [(e["event"], e["model"], e["step"]) for e in events if e["event"] in ("ckpt_promote", "ckpt_reject")]
    assert decisions == [("ckpt_promote", "default", 16), ("ckpt_reject", "default", 24),
                         ("ckpt_promote", "default", 24), ("ckpt_reject", "default", 32)]
    gate, shape = [e for e in events if e["event"] == "ckpt_reject"]
    assert gate["anomalies"][0]["kind"] == "entropy_collapse"
    assert "param tree mismatch" in shape["reason"] and "shape" in shape["reason"]
    assert events[0]["event"] == "serve_start" and events[0]["models"] == ["canary", "default"]
    assert events[-1]["event"] == "run_end" and events[-1]["status"] == "completed"


def test_served_slow_request_chain_is_journaled_with_its_phases(served):
    events = served["journal"]
    kinds = [e["event"] for e in events]
    assert kinds.count("fault_injection") == kinds.count("slow_request") == 1
    assert kinds.count("slo_breach") == kinds.count("slo_breach_end") == 1
    assert kinds.index("fault_injection") < kinds.index("slow_request") < kinds.index("slo_breach_end")
    (slow,) = [e for e in events if e["event"] == "slow_request"]
    assert slow["request_id"] == "req-slow" and slow["model"] == "default" and slow["total_ms"] > 400.0
    assert set(slow["phases"]) == {"queue_ms", "batch_form_ms", "dispatch_ms", "scatter_ms"}
    assert slow["phases"]["dispatch_ms"] > 400.0 and slow["timed_out"] is False


def test_served_metrics_carry_per_model_series(served):
    text = served["metrics"]
    for model in ("default", "canary"):
        assert f'sheeprl_serve_latency_ms_bucket{{model="{model}",le="1",phase="dispatch"}}' in text
        assert f'sheeprl_serve_requests_total{{model="{model}"}}' in text
        assert f'sheeprl_serve_request_log_rows_total{{model="{model}"}}' in text
    assert "sheeprl_serve_models 2" in text and 'models="canary,default"' in text
    assert 'sheeprl_serve_ckpt_rejections_total{model="default"} 2' in text


def test_served_trace_loads_with_a_span_for_each_phase_and_merges_in_trace_report(served, monkeypatch):
    events = served["trace"]
    anchor = next(e for e in events if e.get("name") == "clock_sync")
    assert anchor["args"]["role"] == "server"
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"serve-queue", "serve-batch-form", "serve-dispatch", "serve-scatter", "serve-serialize",
            "serve-session-checkout", "serve-request-log"} <= names
    assert [e["args"]["step"] for e in events if e.get("ph") == "i" and e["name"] == "ckpt_promote"] == [16, 24]
    spec = importlib.util.spec_from_file_location("trace_report", REPO_ROOT / "tools" / "trace_report.py")
    trace_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace_report)
    monkeypatch.setattr(sys, "argv", ["trace_report.py", served["app"].log_dir, "--json"])
    out = io.StringIO()
    with redirect_stdout(out):
        assert trace_report.main() == 0
    report = json.loads(out.getvalue())
    phases = {(r["role"], r["phase"]) for r in report["phases"]}
    assert {("server", "serve-dispatch"), ("server", "serve-queue")} <= phases
    assert any(i["name"] == "ckpt_promote" for i in report["instants"])


def test_served_request_logs_verify_in_both_readers(served):
    answered = {"default": 0, "canary": 0}
    for model, status, _, _ in served["replies"]:
        answered[model] += status == 200
    rotates = [e for e in served["journal"] if e["event"] == "request_log_rotate"]
    assert {e["model"] for e in rotates} == {"default", "canary"} and not any(e.get("dropped") for e in rotates)
    for model, rows in answered.items():
        root = os.path.join(served["app"].log_dir, "requests", model)
        port, ref = OfflineDataset(root), JaxOfflineDataset(root)
        assert port.total_rows == ref.total_rows == rows and not port.skipped and not ref.skipped
        assert ref.meta["meta"]["algo"] == "dreamer_v3" and ref.meta["meta"]["actions_dim"] == list(ACTIONS_DIM)
        mine, theirs = port.gather(0, range(rows)), ref.gather(0, range(rows))
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])
        assert mine["rgb"].dtype == np.uint8 and mine["rgb"].shape == (rows, 3, 16, 16)
        assert 0.0 in mine["is_first"] and 1.0 in mine["is_first"]  # sessions go on, and start


# ---------------------------------------------------------------------------
# the flywheel: served SAC traffic trains SAC offline
# ---------------------------------------------------------------------------


def test_served_sac_traffic_trains_sac_offline(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.envs import dummy, spaces

    orig = dummy.ContinuousDummyEnv.__init__

    def bounded(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.action_space = spaces.Box(-1.0, 1.0, self.action_space.shape, np.float32)

    monkeypatch.setattr(dummy.ContinuousDummyEnv, "__init__", bounded)
    sac = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "algo.hidden_size=8",
           "algo.per_rank_batch_size=4", "algo.mlp_keys.encoder=[state]", "metric.logger=null", "seed=3",
           "fabric.accelerator=cpu"]
    online = cli.run(sac + ["env.num_envs=2", "env.executor=sync", "algo.learning_starts=100", "algo.total_steps=16",
                            "buffer.size=32", "algo.run_test=False", "checkpoint.save_last=True", "run_name=collect"])
    ckpt = online["checkpoints"][-1]
    cfg, path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu",
                                          "serving.reload.enabled=False", "serving.request_log.enabled=True",
                                          "serving.request_log.rotate_rows=8"])
    app = ServeApp(cfg, path, device)
    try:
        host, port = app.start()
        rng = np.random.default_rng(3)
        for _ in range(12):
            status, body, _ = _post(f"http://{host}:{port}", {"obs": {"state": rng.normal(size=10).tolist()}})
            assert status == 200 and np.isfinite(np.asarray(body["action"])).all()
    finally:
        app.close()
    rotates = [e for e in jax_read_journal(os.path.join(app.log_dir, "journal.jsonl"))
               if e["event"] == "request_log_rotate"]
    assert sum(e["rows"] for e in rotates) == 12
    requests = os.path.join(app.log_dir, "requests", "default")
    ref = JaxOfflineDataset(requests)
    assert ref.total_rows == 12 and not ref.skipped and ref.meta["meta"]["algo"] == "sac"
    assert {"observations", "actions", "rewards", "terminated"} <= set(ref.key_specs)
    out = cli.run(sac + ["algo.total_steps=2", "run_name=flywheel", "algo.offline.enabled=true",
                         f"algo.offline.dataset_dir={requests}", "algo.offline.grad_steps_per_iter=2",
                         "checkpoint.save_last=True"])
    assert out["gradient_steps"] == 2
    events = jax_read_journal(os.path.join(os.path.dirname(os.path.dirname(out["checkpoints"][-1])),
                                           "journal.jsonl"))
    opened = next(e for e in events if e["event"] == "dataset_open")
    assert opened["rows"] == 12 and opened["skipped"] == 0
    last = [e for e in events if e["event"] == "metrics"][-1]["metrics"]
    for key in ("Loss/value_loss", "Loss/policy_loss"):
        assert np.isfinite(last[key]), key
