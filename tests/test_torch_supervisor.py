"""The port's auto-restart supervisor (``sheeprl_tpu_torch/resilience/
supervisor.py``) held to the JAX package's: the JAX supervisor tests' stub
children run under both ``supervise_command``\\ s and leave the same
``restart`` rows apart from their times; a supervised
``--kill-after-first-checkpoint`` PPO run on the CPU resumes from the
newest verified checkpoint and completes, and the port's ``goodput_report``
gives the JAX tool's restart accounting of it.  And a tiny DreamerV3 run
with the chaos schedule ``nan_grads`` (``sentinel.policy=warn``) then
``preempt`` in both packages: the same ``fault_injection`` and
``divergence`` events, exit 75 and a checkpoint that verifies."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import sheeprl_tpu.resilience.supervisor as jax_supervisor
import sheeprl_tpu_torch.resilience.supervisor as supervisor
from sheeprl_tpu_torch.resilience.monitor import RESTARTS_ENV_VAR
from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"port": supervisor, "jax": jax_supervisor}

#: the JAX test's stub child: exits with the code its plan file gives this
#: attempt, and records its argv's resume path and the restart count it got
_STUB = """
import json, os, sys
plan_path, log_path = sys.argv[1], sys.argv[2]
lines = open(plan_path).read().split()
attempt = int(lines[0]); rcs = lines[1:]
with open(plan_path, "w") as fp:
    fp.write(" ".join([str(attempt + 1)] + rcs))
with open(log_path, "a") as fp:
    fp.write(json.dumps({"attempt": attempt, "resume": sys.argv[3] if len(sys.argv) > 3 else None,
                         "restarts_env": os.environ.get(%r)}) + "\\n")
sys.exit(int(rcs[min(attempt, len(rcs) - 1)]))
""" % (RESTARTS_ENV_VAR,)


def _stub_builder(work: Path, rcs):
    plan = work / "plan.txt"
    plan.write_text(" ".join(["0"] + [str(rc) for rc in rcs]))
    log = work / "children.jsonl"

    def argv_builder(resume):
        return [sys.executable, "-c", _STUB, str(plan), str(log), *([str(resume)] if resume is not None else [])]

    return argv_builder, log


def _supervised(module, work: Path, rcs, with_checkpoints: bool = False, **kwargs):
    """One scenario under one package's ``supervise_command``: its exit
    code, the sleeps it asked for, the children's records and the restart
    rows without their times (paths relative to ``work``)."""
    from sheeprl_tpu.diagnostics.journal import read_journal

    run_dir = work / "run"
    if with_checkpoints:
        from sheeprl_tpu.resilience.manifest import save_verified_checkpoint

        ckpt_dir = run_dir / "version_0" / "checkpoint"
        ckpt_dir.mkdir(parents=True)
        save_verified_checkpoint(str(ckpt_dir / "ckpt_32_0.ckpt"), {"agent": {"w": np.ones(2, np.float32)},
                                                                     "policy_step": 32})
        (ckpt_dir / "ckpt_48_0.ckpt").write_bytes(b"corrupt newest")
    argv_builder, log = _stub_builder(work, rcs)
    sleeps = []
    rc = module.supervise_command(argv_builder, str(run_dir), sleep_fn=sleeps.append, **kwargs)
    children = [json.loads(line) for line in log.read_text().splitlines()]
    for child in children:
        child["resume"] = child["resume"] and os.path.relpath(child["resume"], work)
    rows = []
    for e in read_journal(str(run_dir / supervisor.SUPERVISOR_JOURNAL)):
        assert "down_s" not in e or isinstance(e["down_s"], (int, float))
        row = {k: v for k, v in e.items() if k not in ("t", "down_s")}
        if row.get("resume_from"):
            row["resume_from"] = os.path.relpath(row["resume_from"], work)
        rows.append(row)
    return {"rc": rc, "sleeps": sleeps, "children": children, "rows": rows}


SCENARIOS = {
    "restarts_until_a_clean_exit": ([1, 1, 0], {"max_restarts": 5, "backoff_base_s": 0.25, "backoff_max_s": 60.0}),
    "budget_exhausted": ([7, 7, 7, 7], {"max_restarts": 2, "backoff_base_s": 0.0}),
    "preempted_respawns_without_backoff": ([PREEMPTED_EXIT_CODE, 0], {"max_restarts": 5, "backoff_base_s": 5.0}),
    "backoff_capped": ([3, 3, 3, 0], {"max_restarts": 5, "backoff_base_s": 0.5, "backoff_max_s": 1.0}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_stub_children_leave_the_jax_supervisors_restart_rows(tmp_path, scenario):
    rcs, kwargs = SCENARIOS[scenario]
    got = {}
    for name, module in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _supervised(module, tmp_path / name, rcs, **kwargs)
    assert got["port"] == got["jax"]
    assert [c["restarts_env"] for c in got["port"]["children"]] == [str(i) for i in range(len(got["port"]["children"]))]


def test_the_restarted_child_resumes_from_the_newest_verified_checkpoint(tmp_path):
    """Both supervisors hand the first spawn and the restart the newest
    checkpoint that verifies, skipping the corrupt newest one."""
    got = {}
    for name, module in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _supervised(module, tmp_path / name, [1, 0], with_checkpoints=True, max_restarts=2,
                                backoff_base_s=0.0)
    assert got["port"] == got["jax"]
    good = os.path.join("run", "version_0", "checkpoint", "ckpt_32_0.ckpt")
    assert [c["resume"] for c in got["port"]["children"]] == [good, good]
    assert got["port"]["rows"][0]["resume_from"] == good


def test_backoff_delay_caps_exponential_growth():
    for module in PACKAGES.values():
        assert [module.backoff_delay(a, 1.0, 60.0) for a in (0, 1, 2, 3, 4, 5, 6, 7)] == [
            0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 60.0]


def test_a_supervised_killed_ppo_run_resumes_and_completes(tmp_path):
    """``python -m sheeprl_tpu_torch.tools.supervise
    --kill-after-first-checkpoint`` on a tiny PPO run on the CPU: the first
    child is SIGKILLed once a verified checkpoint exists, the second resumes
    from the newest one and completes; the port's ``goodput_report`` and the
    JAX ``tools/goodput_report.py`` account the run alike: the killed and
    the completed segment, one restart, its measured downtime."""
    overrides = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.capture_video=False",
                 "buffer.memmap=False", "metric.log_level=1", "metric.log_every=1", "fabric.accelerator=cpu",
                 "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.update_epochs=1", "algo.dense_units=8",
                 "algo.mlp_layers=1", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]",
                 "algo.run_test=False", "run_name=sup_e2e", "algo.total_steps=512", "checkpoint.every=16",
                 "checkpoint.save_last=False", "metric.logger=null", "num_threads=1"]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch.tools.supervise", "--max-restarts", "2",
                           "--backoff", "0.5", "--kill-after-first-checkpoint", *overrides],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run_dir = tmp_path / "logs" / "runs" / "ppo" / "discrete_dummy" / "sup_e2e"
    (restart,) = [json.loads(line) for line in (run_dir / supervisor.SUPERVISOR_JOURNAL).read_text().splitlines()]
    assert restart["rc"] == -9 and restart["preempted"] is False and restart["backoff_s"] == 0.5
    assert Path(restart["resume_from"]).name.startswith("ckpt_") and "version_0" in restart["resume_from"]
    from sheeprl_tpu_torch.diagnostics.journal import read_journal

    resumed = read_journal(str(run_dir / "version_1" / "journal.jsonl"))
    assert resumed[-1]["event"] == "run_end" and resumed[-1]["status"] == "completed"

    reports = {}
    for name, argv in (("port", [sys.executable, "-m", "sheeprl_tpu_torch.tools.goodput_report"]),
                       ("jax", [sys.executable, str(ROOT / "tools" / "goodput_report.py")])):
        out = subprocess.run([*argv, str(run_dir), "--json"], cwd=ROOT, capture_output=True, text=True,
                             timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert out.returncode == 0, out.stderr[-2000:]
        (analysis,) = json.loads(out.stdout).values()
        reports[name] = analysis
    assert reports["port"]["supervisor"] == reports["jax"]["supervisor"]
    assert reports["port"]["supervisor"]["restarts"] == 1 and reports["port"]["supervisor"]["measured_down_s"] >= 0
    assert [s["label"] for s in reports["port"]["segments"]] == [s["label"] for s in reports["jax"]["segments"]]


# ---------------------------------------------------------------------------
# chaos in the DreamerV3 loop, both packages
# ---------------------------------------------------------------------------

def test_a_dreamer_v3_chaos_run_journals_as_the_jax_loop_does(tmp_path, monkeypatch):
    """``nan_grads`` at iteration 6 under ``sentinel.policy=warn`` and
    ``preempt`` at 10, a tiny DreamerV3 run in each package, at one and at
    two gradient steps an iteration (both loops drain one metric row an
    iteration): the same ``fault_injection`` lines, the same
    ``nonfinite_update`` divergence steps and counts, ``preempted`` at 10,
    exit 75 and an emergency checkpoint that verifies."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.diagnostics.journal import read_journal
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from test_torch_dv3_train import RUN

    schedule = "[{iter: 6, fault: nan_grads}, {iter: 10, fault: preempt}]"
    monkeypatch.chdir(tmp_path)
    for replay_ratio in ("0.5", "1.0"):  # 2 envs: one, then two gradient steps an iteration
        overrides = [o for o in RUN if o not in ("diagnostics=off",) and not o.startswith("algo.total_steps")] + [
            "algo.total_steps=32", f"algo.replay_ratio={replay_ratio}", "algo.run_test=False",
            "diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=warn",
            f"diagnostics.resilience.chaos.schedule={schedule}", "metric.log_every=2"]
        codes = {}
        for name, run in (("port", cli.run), ("jax", jax_run)):
            with pytest.raises(SystemExit) as exit_, pytest.warns(RuntimeWarning, match="non-finite training update"):
                run(overrides + [f"root_dir={name}_{replay_ratio}"])
            codes[name] = exit_.value.code
        assert codes == {"port": PREEMPTED_EXIT_CODE, "jax": PREEMPTED_EXIT_CODE}

        records = {}
        for name, verify in (("port", verify_checkpoint), ("jax", jax_verify)):
            events = read_journal(str(next(Path(tmp_path).glob(f"logs/runs/{name}_{replay_ratio}/**/journal.jsonl"))))
            (preempted,) = [e for e in events if e["event"] == "preempted"]
            assert verify(preempted["path"]) == (True, "verified") and events[-1]["status"] == "preempted"
            records[name] = {
                "faults": [(e["iter_num"], e["kind"], e["source"]) for e in events if e["event"] == "fault_injection"],
                "divergence": [(e["step"], e["nonfinite_steps"], e["policy"]) for e in events
                               if e["event"] == "divergence" and e["kind"] == "nonfinite_update"],
                "preempted": (preempted["iter_num"], preempted["reason"], preempted["snapshot_durable"])}
        assert records["port"] == records["jax"], replay_ratio
        assert records["port"]["faults"] == [(6, "nan_grads", "chaos"), (10, "preempt", "chaos")]
        assert records["port"]["divergence"] and records["port"]["preempted"] == (10, "chaos", True)
