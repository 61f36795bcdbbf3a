"""The port's scripted chaos (``sheeprl_tpu_torch/resilience/chaos.py``)
held to the JAX package's: the JAX chaos tests' unit cases (schedule
parsing, ``check_configs``, fire-once, the facade's scheduled trainer
exception and its quarantine) run on both packages; and the drill runs a
tiny coupled PPO schedule of ``slow_write`` then ``preempt`` through each
package's CLI in a child process, both judged alike: exit 75, the two
chains, status ``preempted``, a checkpoint that verifies; the default
workload, decoupled PPO, drills a ``trainer_exception`` on the CPU."""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest

import sheeprl_tpu.resilience.chaos as jax_chaos
import sheeprl_tpu_torch.resilience.chaos as chaos
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

PACKAGES = {"port": chaos, "jax": jax_chaos}


def _errors(module, schedule):
    try:
        return module.parse_schedule(schedule)
    except ValueError as err:
        return f"ValueError: {err}"


@pytest.mark.parametrize("schedule", [
    None, "", [], [{"iter": 2, "fault": "nan_grads"}], [{"iter": "3", "fault": "preempt"}, {"iter": 1, "fault": "slow_write"}],
    [{"iter": 2, "fault": "meteor_strike"}], [{"fault": "nan_grads"}], [{"iter": 0, "fault": "preempt"}],
    {"iter": 2, "fault": "nan_grads"}, "preempt", [3],
])
def test_parse_schedule_gives_the_jax_entries_and_messages(schedule):
    assert _errors(chaos, schedule) == _errors(jax_chaos, schedule)


def test_parse_schedule_validates_entries():
    assert chaos.parse_schedule([{"iter": 2, "fault": "nan_grads"}]) == [
        {"iter": 2, "fault": "nan_grads", "fired": False}]
    assert chaos.FAULTS == jax_chaos.FAULTS


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_check_configs_rejects_bad_chaos_and_isolation_knobs(package):
    if package == "port":
        from sheeprl_tpu_torch.cli import check_configs
        from sheeprl_tpu_torch.config import compose
    else:
        from sheeprl_tpu.cli import check_configs
        from sheeprl_tpu.config import compose

    base = ["exp=ppo", "env=dummy", "env.id=discrete_dummy"]
    with pytest.raises(ValueError, match="unknown fault"):
        check_configs(compose(base + ["diagnostics.resilience.chaos.schedule=[{iter: 2, fault: nope}]"]))
    with pytest.raises(ValueError, match="slow_write_s"):
        check_configs(compose(base + ["diagnostics.resilience.chaos.slow_write_s=0"]))
    with pytest.raises(ValueError, match="max_staleness"):
        check_configs(compose(base + ["diagnostics.resilience.isolation.max_staleness=0"]))
    with pytest.raises(ValueError, match="retry_budget"):
        check_configs(compose(base + ["diagnostics.resilience.isolation.retry_budget=-1"]))
    check_configs(compose(base + ["diagnostics.resilience.chaos.schedule=[{iter: 3, fault: preempt}]"]))


def test_the_monitors_refuse_a_bad_slow_write_alike():
    cfg = {"diagnostics": {"resilience": {"chaos": {"slow_write_s": -1}}}}
    messages = []
    for module in (chaos, jax_chaos):
        with pytest.raises(ValueError) as err:
            module.ChaosMonitor(cfg)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "diagnostics.resilience.chaos.slow_write_s must be > 0, got -1.0"


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_chaos_monitor_fires_each_entry_once(package):
    events = []
    monitor = PACKAGES[package].ChaosMonitor({"diagnostics": {"resilience": {"chaos": {"schedule": [
        {"iter": 2, "fault": "nan_grads"}, {"iter": 2, "fault": "slow_write"}, {"iter": 4, "fault": "nan_grads"}]}}}})
    assert not monitor.take(2, "nan_grads")  # not opened: nothing fires
    monitor.open(lambda event, **fields: events.append({"event": event, **fields}))
    assert not monitor.take(1, "nan_grads")
    assert monitor.take(2, "nan_grads")
    assert not monitor.take(2, "nan_grads")  # one-shot
    assert monitor.take(2, "slow_write")  # a distinct fault at the same iteration
    assert monitor.take(4, "nan_grads")  # a second entry for the same fault
    assert [(e["iter_num"], e["kind"]) for e in events] == [(2, "nan_grads"), (2, "slow_write"), (4, "nan_grads")]
    assert all(e["event"] == "fault_injection" and e["source"] == "chaos" for e in events)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_facade_raises_scheduled_trainer_exception_once(tmp_path, package):
    if package == "port":
        from sheeprl_tpu_torch.diagnostics import Diagnostics
        from sheeprl_tpu_torch.diagnostics.journal import read_journal
    else:
        from sheeprl_tpu.diagnostics import Diagnostics, read_journal
    error = PACKAGES[package].ChaosTrainerError

    cfg = {"diagnostics": {"enabled": True, "resilience": {
        "chaos": {"schedule": [{"iter": 3, "fault": "trainer_exception"}]}}}}
    diag = Diagnostics(cfg).open(str(tmp_path))
    try:
        diag.maybe_chaos_trainer_fault(2)  # not scheduled: no-op
        with pytest.raises(error, match="iteration 3"):
            diag.maybe_chaos_trainer_fault(3)
        diag.maybe_chaos_trainer_fault(3)  # one-shot
        assert diag.quarantine(error("chaos"), 3, 48) is None  # no snapshot yet
        diag.refresh_last_good(2, {"w": np.ones(2, np.float32)}, {"mu": np.zeros(2, np.float32)})
        assert not diag.fence_halt_due() and diag.last_good_state()["iter_num"] == 2
        restored = diag.quarantine(error("chaos"), 3, 48)
        assert restored is not None and restored["iter_num"] == 2
    finally:
        diag.close()
    events = read_journal(str(tmp_path / "journal.jsonl"))
    (fault,) = [e for e in events if e["event"] == "fault_injection"]
    assert fault == {**fault, "iter_num": 3, "kind": "trainer_exception", "source": "chaos"}
    (rollback,) = [e for e in events if e["event"] == "rollback"]
    assert rollback["restored_iter"] == 2 and rollback["retries_left"] == 2


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_nan_grads_poisons_the_scheduled_batch_only(tmp_path, package):
    if package == "port":
        import torch

        from sheeprl_tpu_torch.diagnostics import Diagnostics
        batch = {"obs": torch.ones(2, 3), "actions": torch.ones(2, 1)}

        def finite(tree):
            return bool(torch.isfinite(tree["obs"]).all())
    else:
        import jax.numpy as jnp

        from sheeprl_tpu.diagnostics import Diagnostics
        batch = {"obs": jnp.ones((2, 3)), "actions": jnp.ones((2, 1))}

        def finite(tree):
            return bool(jnp.isfinite(tree["obs"]).all())

    cfg = {"diagnostics": {"enabled": True, "resilience": {"chaos": {"schedule": [{"iter": 2, "fault": "nan_grads"}]}}}}
    diag = Diagnostics(cfg).open(str(tmp_path))
    try:
        assert diag.maybe_inject_nan(1, batch) is batch
        assert not finite(diag.maybe_inject_nan(2, batch))
        assert diag.maybe_inject_nan(2, batch) is batch  # one-shot
    finally:
        diag.close()


# ---------------------------------------------------------------------------
# the drill through each package's CLI
# ---------------------------------------------------------------------------

SCHEDULE = [{"iter": 2, "fault": "slow_write"}, {"iter": 4, "fault": "preempt"}]
SLOW_WRITE_S = 0.3


def _drill_record(verdict):
    """What a verdict says, without paths and times."""
    events = [json.loads(line) for line in Path(verdict["journal"]).read_text().splitlines()]
    chain = [(e["event"], e.get("iter_num"), e.get("kind"), e.get("source"), e.get("reason"))
             for e in events if e["event"] in ("fault_injection", "preempted")]
    slow = [e["queued_s"] >= SLOW_WRITE_S for e in events if e["event"] == "ckpt_end"]
    return {"ok": verdict["ok"], "exit_code": verdict["exit_code"], "schedule": verdict["schedule"],
            "checks": {k: v["ok"] for k, v in verdict["checks"].items()}, "chain": chain, "slow_ckpt": any(slow),
            "status": events[-1].get("status")}


def test_the_drill_judges_a_port_run_as_the_jax_drill_judges_the_jax_run(tmp_path, monkeypatch):
    """``run_drill`` with a tiny coupled PPO run on the CPU and the schedule
    ``slow_write`` at iteration 2, ``preempt`` at 4, in each package: the
    child exits 75; ``fault_injection -> ckpt_end -> run_end`` and
    ``fault_injection -> preempted -> run_end`` in order; status
    ``preempted``; a final checkpoint that verifies; a ``ckpt_end`` queued
    at least ``slow_write_s``.  The two verdicts and journals agree."""
    from test_torch_ppo import RUN

    overrides = [o for o in RUN if not o.startswith(("algo.total_steps", "checkpoint.every"))] + [
        "algo.total_steps=48", "checkpoint.every=8", "algo.run_test=False",
        f"diagnostics.resilience.chaos.slow_write_s={SLOW_WRITE_S}"]
    records = {}
    for name, module in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        records[name] = _drill_record(module.run_drill(module.parse_schedule(SCHEDULE), overrides, timeout_s=300))
    assert records["port"] == records["jax"]
    assert records["port"]["ok"] and records["port"]["exit_code"] == 75 and records["port"]["status"] == "preempted"
    assert records["port"]["slow_ckpt"]
    assert records["port"]["chain"] == [("fault_injection", 2, "slow_write", "chaos", None),
                                        ("fault_injection", 4, "preempt", "chaos", None),
                                        ("preempted", 4, None, None, "chaos")]


def test_the_drill_judges_a_missing_journal_and_a_wrong_exit(tmp_path):
    """No journal of the drill's run name and an exit code the schedule
    does not allow: both checks fail, and so does the verdict."""
    verdict = chaos.judge_drill(chaos.parse_schedule(SCHEDULE), 1, str(tmp_path))
    assert verdict["ok"] is False
    assert verdict["checks"]["exit_code"]["ok"] is False and sorted(verdict["checks"]["exit_code"]["detail"]["want"]) == [0, 75]
    assert verdict["checks"]["journal"]["ok"] is False


def test_main_without_overrides_refuses_and_names_the_parallel_item(tmp_path, monkeypatch, capsys):
    """The drill's default workload is the JAX package's, a decoupled PPO
    run of one player and one trainer: the port's list is the JAX list less
    ``fabric.accelerator=cpu`` (the drill runs on the card unless told
    otherwise).  With that entry appended the default drill of a
    ``trainer_exception`` passes on the CPU: exit 0, the chain
    ``fault_injection -> rollback -> run_end``, a final checkpoint that
    verifies.  A drill given both a fault and a schedule is still refused."""
    assert chaos.DEFAULT_OVERRIDES == [o for o in jax_chaos.DEFAULT_OVERRIDES if o != "fabric.accelerator=cpu"]
    assert "exp=ppo_decoupled" in chaos.DEFAULT_OVERRIDES and "fabric.devices=2" in chaos.DEFAULT_OVERRIDES
    monkeypatch.chdir(tmp_path)
    code = chaos.main(["--drill", "trainer_exception", "--", *chaos.DEFAULT_OVERRIDES, "fabric.accelerator=cpu"])
    out = capsys.readouterr().out
    verdict = json.loads(out.splitlines()[0])
    assert code == 0 and verdict["ok"] and "chaos drill: PASSED" in out
    assert verdict["checks"]["chain:trainer_exception"]["ok"] and verdict["checks"]["final_checkpoint_verifies"]["ok"]
    assert re.search(r"ppo_decoupled/discrete_dummy/chaos_drill", verdict["journal"])
    with pytest.raises(SystemExit):
        chaos.main(["--drill", "preempt", "--schedule", "[]", "--", "exp=ppo"])
