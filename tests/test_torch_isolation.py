"""The port's fault isolation (``sheeprl_tpu_torch/resilience/isolation.py``)
held to the JAX package's: the same scripted ``judge`` / ``refresh`` /
``rollback`` sequences give the same verdicts, staleness, journaled events,
gauges, counters and summary, and a refreshed snapshot equals the trees it
was taken from; and the fault the port had (its coupled runs dropped the
isolation layer's ``/metrics`` counters, summary fields and knob checks)
closed: a tiny coupled PPO run on the CPU in both packages carries the same
isolation counters in ``/metrics`` and the same ``telemetry_summary``
fields, and a bad knob raises in both."""

from __future__ import annotations

import re
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu.resilience.isolation import IsolationHalt as JaxIsolationHalt
from sheeprl_tpu.resilience.isolation import IsolationMonitor as JaxIsolationMonitor
from sheeprl_tpu_torch.diagnostics.sentinel import SentinelHalt
from sheeprl_tpu_torch.resilience.isolation import IsolationHalt, IsolationMonitor, host_tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

HEALTHY = {"grad_norm": 1.25, "update_norm": 0.01, "param_norm": 10.0}
PACKAGES = {"port": IsolationMonitor, "jax": JaxIsolationMonitor}


def _opened(cls, **iso):
    events, syncs = [], []
    monitor = cls({"diagnostics": {"resilience": {"isolation": dict(iso)}}})
    monitor.open(lambda kind, **fields: events.append({"event": kind, **fields}), lambda: syncs.append(1))
    return monitor, events, syncs


def _observed(monitor, events, syncs, verdicts):
    return {"verdicts": verdicts, "staleness": monitor.staleness, "halt_due": monitor.halt_due,
            "events": events, "syncs": len(syncs), "interval": monitor.interval_metrics(),
            "gauges": monitor.gauges(), "counters": monitor.counters(), "summary": monitor.summary(),
            "can_absorb": monitor.can_absorb()}


# each script: the knobs, then (call, args) steps; a "rollback" step passes
# one shared error object so both packages journal the same repr
ERROR = RuntimeError("chaos: injected trainer exception at iteration 6")
SCRIPTS = {
    "each_signal_then_recovery": ({}, [
        ("judge", (1, 16, HEALTHY, 0.0, ())), ("judge", (2, 32, HEALTHY, 2.0, ())),
        ("judge", (3, 48, {**HEALTHY, "grad_norm": float("nan")}, 0.0, ())),
        ("judge", (4, 64, {**HEALTHY, "param_norm": float("inf")}, 0.0, ())),
        ("judge", (5, 80, HEALTHY, 0.0, ("loss_plateau", "entropy_collapse"))), ("judge", (6, 96, HEALTHY, 0.0, ()))]),
    "anomaly_veto_off": ({"reject_on_anomaly": False}, [("judge", (1, 16, HEALTHY, 0.0, ("entropy_collapse",)))]),
    "escalation_once_past_budget": ({"max_staleness": 2}, [
        ("judge", (i, 16 * i, HEALTHY, 0.0, ("entropy_collapse",))) for i in range(1, 5)] + [
        ("judge", (5, 80, HEALTHY, 1.0, ())), ("judge", (6, 96, HEALTHY, 1.0, ()))]),
    "rollback_until_the_budget_is_spent": ({"retry_budget": 2}, [
        ("rollback", (1, 16)), ("refresh", (1,)), ("judge", (2, 32, HEALTHY, 0.0, ())), ("refresh", (2,)),
        ("rollback", (3, 48)), ("rollback", (4, 64)), ("rollback", (5, 80))]),
    "refresh_every_third": ({"refresh_every": 3}, [
        ("refresh", (1,)), ("refresh", (2,)), ("refresh", (3,)), ("refresh", (4,)), ("rollback", (5, 80))]),
    "no_rollback_after_the_fence_halts": ({"max_staleness": 1}, [
        ("refresh", (1,)), ("judge", (2, 32, HEALTHY, 1.0, ())), ("judge", (3, 48, HEALTHY, 1.0, ())),
        ("rollback", (4, 64))]),
}


def _trees(iter_num: int):
    """Params and optimizer state that differ by iteration, as numpy."""
    rng = np.random.default_rng(iter_num)
    params = {"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                        "bias": rng.normal(size=(2,)).astype(np.float32)}}
    opt_state = ({"mu": rng.normal(size=(3, 2)).astype(np.float32)}, np.asarray(iter_num, np.int32))
    return params, opt_state


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _run(cls, knobs, steps, torch_trees: bool):
    monitor, events, syncs = _opened(cls, **knobs)
    verdicts, restored = [], []
    for call, args in steps:
        if call == "judge":
            verdicts.append(monitor.judge(*args))
        elif call == "refresh":
            params, opt_state = _trees(args[0])
            if torch_trees:
                params, opt_state = _as_torch(params), _as_torch(opt_state)
            monitor.refresh(args[0], params, opt_state)
        else:
            got = monitor.rollback(ERROR, *args)
            restored.append(None if got is None else got["iter_num"])
            verdicts.append(got is not None)
    return _observed(monitor, events, syncs, verdicts), restored


def _without_time(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_sequences_give_the_jax_monitors_record(script):
    knobs, steps = SCRIPTS[script]
    port, port_restored = _run(IsolationMonitor, knobs, steps, torch_trees=True)
    jax, jax_restored = _run(JaxIsolationMonitor, knobs, steps, torch_trees=False)
    port["events"], jax["events"] = _without_time(port["events"]), _without_time(jax["events"])
    assert port == jax
    assert port_restored == jax_restored


def test_a_refreshed_snapshot_equals_the_trees_and_owns_its_memory():
    """The last-good copy holds the converted trees' values, as host
    tensors, and a later in-place step of the live trees (the port's
    optimizers update in place) does not reach it; the JAX monitor's copy
    holds the same values."""
    monitor, _, _ = _opened(IsolationMonitor)
    jax_monitor, _, _ = _opened(JaxIsolationMonitor)
    params, opt_state = _trees(7)
    live_params, live_opt = _as_torch(params), _as_torch(opt_state)
    monitor.refresh(7, live_params, live_opt)
    jax_monitor.refresh(7, params, opt_state)
    live_params["dense"]["kernel"].add_(1.0)
    live_opt[0]["mu"].mul_(0.0)
    good, jax_good = monitor.last_good, jax_monitor.last_good
    assert good["iter_num"] == jax_good["iter_num"] == 7
    assert isinstance(good["params"]["dense"]["kernel"], torch.Tensor)
    assert good["params"]["dense"]["kernel"].device.type == "cpu"
    np.testing.assert_array_equal(good["params"]["dense"]["kernel"].numpy(), np.asarray(jax_good["params"]["dense"]["kernel"]))
    np.testing.assert_array_equal(good["params"]["dense"]["bias"].numpy(), np.asarray(jax_good["params"]["dense"]["bias"]))
    np.testing.assert_array_equal(good["opt_state"][0]["mu"].numpy(), np.asarray(jax_good["opt_state"][0]["mu"]))
    assert int(good["opt_state"][1]) == int(np.asarray(jax_good["opt_state"][1])) == 7
    # double-buffered: the next refresh fills the other slot
    first_slot = monitor._current
    monitor.refresh(8, *_as_torch(_trees(8)))
    assert monitor._current == 1 - first_slot and monitor.last_good["iter_num"] == 8


def test_host_tensors_copies_every_leaf():
    tree = {"a": torch.ones(2), "b": [np.zeros(3), 4], "c": (torch.zeros(1, dtype=torch.bfloat16),)}
    out = host_tensors(tree)
    assert out["b"][1] == 4 and isinstance(out["b"], list) and isinstance(out["c"], tuple)
    assert out["c"][0].dtype == torch.bfloat16
    tree["a"].add_(1.0)
    tree["b"][0][:] = 5.0
    assert torch.equal(out["a"], torch.ones(2)) and not out["b"][0].any()


@pytest.mark.parametrize("knobs, match", [
    ({"max_staleness": 0}, "max_staleness must be >= 1, got 0"),
    ({"retry_budget": -1}, "retry_budget must be >= 0, got -1"),
    ({"refresh_every": 0}, "refresh_every must be >= 1, got 0"),
])
def test_bad_knobs_raise_in_both_monitors_and_both_check_configs(knobs, match):
    from sheeprl_tpu.cli import check_configs as jax_check_configs
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config import compose

    cfg = {"diagnostics": {"resilience": {"isolation": knobs}}}
    for cls in PACKAGES.values():
        with pytest.raises(ValueError, match=re.escape(match)):
            cls(cfg)
    (key, value), = knobs.items()
    overrides = ["exp=ppo", "env=dummy", f"diagnostics.resilience.isolation.{key}={value}"]
    for check, comp in ((check_configs, compose), (jax_check_configs, jax_compose)):
        with pytest.raises(ValueError, match=re.escape(match)):
            check(comp(overrides))


def test_isolation_halt_closes_a_run_as_halted():
    assert issubclass(IsolationHalt, SentinelHalt) and issubclass(JaxIsolationHalt, Exception)


# ---------------------------------------------------------------------------
# the fault: the coupled runs' counters and summary
# ---------------------------------------------------------------------------

ISOLATION_LINES = re.compile(r"^sheeprl_(params_rejected_total|rollbacks_total|param_staleness\w*)[ {].*$", re.M)


def _scraping_close(monkeypatch, facade_cls, scraped: dict, key: str):
    """Read the live ``/metrics`` as the run's facade closes (the endpoint
    serves until then)."""
    close = facade_cls.close

    def spy(self, status="completed"):
        if key not in scraped and getattr(self, "metrics_server", None) is not None:
            host, port = self.metrics_server.address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as resp:
                scraped[key] = resp.read().decode()
        return close(self, status)

    monkeypatch.setattr(facade_cls, "close", spy)


def test_a_coupled_run_carries_the_jax_isolation_counters_and_summary(tmp_path, monkeypatch):
    """A tiny PPO run with the default isolation layer in both packages: the
    JAX run's ``/metrics`` has ``params_rejected_total`` and
    ``rollbacks_total`` (no staleness gauge: no coupled loop consults the
    gate) and its ``telemetry_summary`` ``params_rejected``, ``rollbacks``
    and ``rollback_retries_left``; the port's the same."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.diagnostics import Diagnostics as JaxDiagnostics
    from sheeprl_tpu.diagnostics.journal import read_journal
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.diagnostics.facade import Diagnostics
    from test_torch_ppo import RUN

    monkeypatch.chdir(tmp_path)
    scraped: dict = {}
    _scraping_close(monkeypatch, Diagnostics, scraped, "port")
    _scraping_close(monkeypatch, JaxDiagnostics, scraped, "jax")
    http = ["diagnostics.telemetry.http.enabled=True", "diagnostics.telemetry.http.port=0", "algo.run_test=False"]
    cli.run(RUN + http + ["root_dir=port"])
    jax_run(RUN + http + ["root_dir=jax"])

    lines = {k: sorted(ISOLATION_LINES.findall(text)) for k, text in scraped.items()}
    assert lines["port"] == lines["jax"] == ["params_rejected_total", "rollbacks_total"]
    values = {k: sorted(m.group(0) for m in ISOLATION_LINES.finditer(text)) for k, text in scraped.items()}
    assert values["port"] == values["jax"]
    fields = ("params_rejected", "rollbacks", "rollback_retries_left")
    summaries = {}
    for root in ("port", "jax"):
        events = read_journal(str(next(Path(tmp_path).glob(f"logs/runs/{root}/**/journal.jsonl"))))
        summary = next(e for e in events if e["event"] == "telemetry_summary")
        summaries[root] = {k: summary.get(k) for k in fields}
    assert summaries["port"] == summaries["jax"] == {"params_rejected": 0, "rollbacks": 0, "rollback_retries_left": 3}
