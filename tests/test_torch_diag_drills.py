"""The DreamerV3 loop under its default diagnostics and under
``diagnostics=full``, on the CPU at a test width, with the JAX package's
readers and report tools on its run directory; the drills: a poisoned
batch under ``skip_update`` leaves every state bit-identical, a preemption
exits 75 with a verified emergency checkpoint that resumes, an async
snapshot is taken before ``submit`` returns; and the transfer guard's
plumbing, which has nothing to count on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu.diagnostics.journal import find_journal as jax_find_journal
from sheeprl_tpu.diagnostics.journal import read_journal as jax_read_journal
from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state
from sheeprl_tpu_torch.diagnostics import Diagnostics
from sheeprl_tpu_torch.diagnostics.memory import MemoryMonitor, sync_guard
from sheeprl_tpu_torch.diagnostics.sentinel import poison_tree
from sheeprl_tpu_torch.resilience.async_writer import AsyncCheckpointWriter
from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE, PreemptedExit
from sheeprl_tpu_torch.utils.checkpoint import OptaxState, load_state
from test_torch_dv3_train import RUN, _batch, _Setup
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parents[1]
ON = [o for o in RUN if o != "diagnostics=off"]
TOOLS = ("journal_report.py", "goodput_report.py", "health_report.py", "trace_report.py")


def _tool(name, run_dir):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(ROOT / "tools" / name), str(run_dir)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("preset", ["default", "full"])
def test_run_under_diagnostics_leaves_a_journal_the_jax_tools_read(tmp_path, monkeypatch, preset):
    monkeypatch.chdir(tmp_path)
    out = cli.run(ON + [f"diagnostics={preset}", "checkpoint.every=8"])
    run_dir = Path(out["log_dir"]).resolve()
    events = jax_read_journal(jax_find_journal(str(run_dir)))
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end" and events[-1]["status"] == "completed"
    assert {"metrics", "ckpt_begin", "ckpt_end", "checkpoint", "telemetry_cost", "memory_breakdown",
            "telemetry_summary", "memory_summary", "state_change"} <= set(kinds)
    gauges = {k for e in events if e["event"] == "metrics" for k in e["metrics"]}
    assert {"Telemetry/sps", "Telemetry/phase_pct/train", "Telemetry/host_rss_bytes", "Telemetry/goodput",
            "Telemetry/health/grad_norm", "Telemetry/health/dead_frac", "Telemetry/health/update_ratio"} <= gauges
    assert not any(k.startswith("Telemetry/hbm") for k in gauges)  # the CPU has no device memory to report
    assert "Telemetry/mfu" not in gauges  # nor a peak
    ends = [e for e in events if e["event"] == "ckpt_end"]
    assert len(ends) == len(out["checkpoints"]) == 2 and all(e["status"] == "ok" and e["verified"] for e in ends)
    for ckpt in out["checkpoints"]:
        assert jax_verify_checkpoint(ckpt) == (True, "verified")
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    assert set(out["health_rows"]) >= {"grad_norm", "dead_frac"}
    if preset == "full":
        assert "module/world_model/update_ratio" in out["health_rows"]
        trace = json.loads((run_dir / "trace.json").read_text())
        names = {e.get("name") for e in trace}
        assert {"rollout", "train", "buffer-sample", "env_wait", "checkpoint"} <= names
        assert any(e["event"] == "metrics_server" and e["status"] == "serving" for e in events)
    for tool in TOOLS:
        if tool == "trace_report.py" and preset != "full":
            continue
        done = _tool(tool, run_dir)
        assert done.returncode == 0, (tool, done.stdout[-2000:], done.stderr[-2000:])


def _state_of(agent, optimizers, moments):
    out = {f"{name}.{i}": p.detach().clone() for name in ("world_model", "actor", "critic", "target_critic")
           for i, p in enumerate(getattr(agent, name).parameters())}
    for name, opt in optimizers.items():
        for i, s in enumerate(opt.state.values()):
            out.update({f"adam.{name}.{i}.{k}": v.detach().clone() for k, v in s.items()})
    out.update({f"moments.{k}": v.clone() for k, v in moments.items()})
    return out


def test_skip_update_leaves_every_state_bit_identical_across_a_poisoned_step():
    setup = _Setup("multidiscrete_dummy", (2, 2), False,
                   ("diagnostics.enabled=True", "diagnostics.sentinel.enabled=True",
                    "diagnostics.sentinel.policy=skip_update"))
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, False)
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in _batch(setup, 3).items()}
    gen = torch.Generator().manual_seed(1)
    moments = init_moments_state()
    for poisoned_first in (True, False):  # a skipped first step, and one after a real step
        if not poisoned_first:
            moments, metrics = step(moments, batch, 1.0, gen)
            assert torch.isfinite(metrics).all()
        before = _state_of(agent, optimizers, moments)
        moments, metrics = step(moments, poison_tree(batch), 0.02, gen)
        assert not torch.isfinite(metrics[:len(METRIC_ORDER)]).any()
        after = _state_of(agent, optimizers, moments)
        assert list(after) == list(before) and len(after) > 100
        for key, value in before.items():
            assert torch.equal(after[key], value), key
    # and the next clean step trains
    moments, metrics = step(moments, batch, 0.02, gen)
    assert torch.isfinite(metrics).all()
    assert not torch.equal(_state_of(agent, optimizers, moments)["world_model.0"], before["world_model.0"])


def test_preemption_exits_75_with_a_verified_emergency_checkpoint_that_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    overrides = ON + ["diagnostics=full", "diagnostics.resilience.inject_preempt_iter=6",
                      "diagnostics.sentinel.inject_nan_iter=5", "diagnostics.resilience.async_checkpoint=False",
                      "diagnostics.telemetry.http.enabled=False", "metric.log_every=2"]
    with pytest.raises(PreemptedExit) as info:
        cli.run(overrides)
    assert info.value.code == PREEMPTED_EXIT_CODE == 75
    (run_dir,) = (tmp_path / "logs" / "runs").rglob("version_0")
    events = jax_read_journal(str(run_dir / "journal.jsonl"))
    kinds = [e["event"] for e in events]
    assert kinds[-1] == "run_end" and events[-1]["status"] == "preempted"
    (preempted,) = [e for e in events if e["event"] == "preempted"]
    assert preempted["reason"] == "injected" and preempted["snapshot_durable"] and preempted["iter_num"] == 6
    ckpt = preempted["path"]
    assert Path(ckpt).name == "ckpt_12_0.ckpt"
    assert verify_checkpoint(ckpt) == jax_verify_checkpoint(ckpt) == (True, "verified")
    (end,) = [e for e in events if e["event"] == "ckpt_end"]
    assert end["blocking"] and end["write_ms"] > 0
    # the poisoned steps of iteration 5 were discarded and journaled
    divergence = [e for e in events if e["event"] == "divergence"]
    assert divergence and divergence[0]["kind"] == "nonfinite_update" and divergence[0]["policy"] == "skip_update"
    assert all(np.isfinite(np.asarray(v)).all() for v in _arrays(load_state(ckpt)))

    resumed = cli.run(overrides[:-5] + [f"checkpoint.resume_from={run_dir}"])
    assert resumed["start_iter"] == 7 and resumed["policy_steps"] == 16


def _arrays(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _arrays(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _arrays(v)]
    return [tree] if isinstance(tree, np.ndarray) and tree.dtype.kind == "f" else []


def test_the_preemption_drill_through_the_command_line(tmp_path):
    """``python -m sheeprl_tpu_torch run`` under SIGTERM-style preemption
    (the drill) exits with code 75."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "run", *ON,
                           "diagnostics.resilience.inject_preempt_iter=3"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 75, done.stderr[-2000:]


def test_an_async_snapshot_is_complete_before_submit_returns(tmp_path):
    """In place updates right after ``submit`` (the next step's) never reach
    the checkpoint: the snapshot is host copies taken on the calling thread,
    optax stand-ins and the replay's numpy storage included."""
    events = []
    writer = AsyncCheckpointWriter(journal_fn=lambda e, **f: events.append((e, f)), max_pending=1)
    adam = OptaxState.make("optax._src.transform", "ScaleByAdamState")
    weights = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    moment = np.ones(4, np.float32)
    ring = np.zeros((5, 2), np.float32)
    state = {"w": weights, "opt": (adam(np.asarray(1, np.int32), {"m": moment}, {"m": moment * 2}),),
             "rb": {"buffer": ring}, "iter_num": 3}
    path = str(tmp_path / "ckpt_3_0.ckpt")
    try:
        writer.submit(path, state, step=3)
        weights.add_(100.0)
        moment += 100.0
        ring += 100.0
        assert writer.drain(timeout=30)
    finally:
        writer.close()
    saved = load_state(path)
    np.testing.assert_array_equal(saved["w"], np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_array_equal(saved["opt"][0][1]["m"], np.ones(4, np.float32))
    np.testing.assert_array_equal(saved["rb"]["buffer"], np.zeros((5, 2), np.float32))
    assert verify_checkpoint(path) == jax_verify_checkpoint(path) == (True, "verified")
    assert [e for e, _ in events] == ["ckpt_begin", "ckpt_end"] and events[1][1]["status"] == "ok"


def test_the_sync_guard_is_plumbed_and_inert_on_the_cpu():
    with sync_guard("disallow", "cpu") as syncs:
        torch.ones(3).sum().item()
    assert syncs == []
    monitor = MemoryMonitor({"diagnostics": {"transfers": "log", "memory": {"inject_oom_iter": 2}}})
    events = []
    monitor.open(lambda e, **f: events.append((e, f)), lambda: None, device="cpu")

    class Inst:
        name, kind = "train_step", "train"

    assert monitor.guarded_call(Inst, lambda: torch.ones(2), (), {}).sum() == 2
    with pytest.raises(torch.cuda.OutOfMemoryError):
        monitor.guarded_call(Inst, lambda: torch.ones(2), (), {})
    kinds = [e for e, _ in events]
    assert kinds == ["host_transfer", "memory_breakdown", "oom"]
    assert events[0][1]["syncs_per_dispatch"] == 0 and events[1][1]["source"] == "none"


def test_the_metrics_endpoint_serves_the_run(tmp_path):
    diag = Diagnostics({"diagnostics": {"enabled": True, "telemetry": {"http": {"enabled": True, "port": 0}},
                                        "goodput": {"watchdog": {"enabled": False}},
                                        "resilience": {"preempt": {"enabled": False}}},
                        "algo": {"name": "dreamer_v3"}})
    try:
        diag.open(str(tmp_path / "run" / "version_0"), device="cpu")
        diag.log_metrics(8, diag.augment_metrics(8, {"Loss/world_model_loss": 1.0}))
        with urllib.request.urlopen(diag.metrics_url + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(diag.metrics_url + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
    finally:
        diag.close("completed")
    assert "sheeprl_run_state" in text and "sheeprl_recompiles_total" in text
    assert health["status"] == "ok"
