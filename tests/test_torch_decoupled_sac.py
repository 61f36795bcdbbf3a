"""The port's decoupled SAC (``sheeprl_tpu_torch/algos/sac/sac_decoupled.py``)
held to the JAX package's (``sheeprl_tpu/algos/sac/sac_decoupled.py``).

- The trainer update: two consecutive train calls over the trainer shards
  of ``fabric.devices=3`` (one player, two trainer shards) from converted
  params, the batch cut along axis 1 (the JAX ``P(None, "data")``) and the
  JAX keys' normal draws injected (the step folds no key, so every shard
  draws the same), against the JAX ``make_train_step`` over a two-device
  trainer mesh of the virtual CPU devices 1 and 2; the replicas bitwise
  equal after each; only the actor goes to the player.
- The loop at two and three devices: the axis-1 cut of each train call,
  the player's own actor, checkpoints with the Ratio and the replay, the
  resume; a rejected promotion and a rollback; a sampling failure is not
  quarantined; the fence halt's last-good checkpoint and its counters.
- Checkpoints across packages with the Ratio on resume (one JAX loop: it
  resumes from the port's checkpoint and trains as the port does from it,
  and the port resumes from the JAX run's).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
from sheeprl_tpu_torch.algos.sac import sac as sac_module
from sheeprl_tpu_torch.diagnostics import Diagnostics
from sheeprl_tpu_torch.diagnostics.journal import read_journal
from sheeprl_tpu_torch.parallel.dp import replicas_equal, run_shards, split, state_tensors
from sheeprl_tpu_torch.parallel.mesh import replicate
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_droq import bounded  # noqa: F401 (a fixture: both packages' continuous dummy env in [-1, 1])
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

RUN = ["exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "env.num_envs=2",
       "env.executor=sync", "fabric.accelerator=cpu", "metric.logger=null", "algo.hidden_size=8",
       "algo.per_rank_batch_size=4", "algo.mlp_keys.encoder=[state]", "algo.learning_starts=8",
       "algo.total_steps=24", "buffer.size=32", "buffer.checkpoint=True", "checkpoint.every=8", "algo.run_test=False",
       "seed=3", "metric.log_every=1"]
NAN_AT_6 = ["diagnostics.resilience.chaos.schedule=[{iter: 6, fault: nan_grads}]"]
HALT = ["diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=halt"]
TRAINER_SHARDS = 2


def _host(tensors):
    return [t.detach().cpu().clone() for t in tensors]


def _bitwise(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


def _journal(log_dir):
    return read_journal(str(Path(log_dir) / "journal.jsonl"))


def _calls(events):
    (summary,) = [e for e in events if e["event"] == "telemetry_summary"]
    return summary["instrumented_calls"]


# ---------------------------------------------------------------------------
# the trainer update against the JAX step over a two-device trainer mesh


@pytest.fixture(scope="module")
def jax_trainer():
    """SAC's tiny setup and the JAX step over the trainer sub-mesh of
    devices 1..2, compiled once."""
    import test_torch_sac as ts
    from jax.sharding import Mesh

    from sheeprl_tpu.algos.sac.sac import make_train_step as jax_make_train_step

    assert len(jax.devices()) >= 1 + TRAINER_SHARDS
    setup = ts.Setup(ts.TINY)
    steps = ts.Steps(setup)
    trainer_mesh = Mesh(np.asarray(jax.devices()[1:1 + TRAINER_SHARDS]), ("data",))
    step = jax_make_train_step(setup.actor_def, setup.critic_def, steps.jax_opts, steps.jax_cfg, trainer_mesh,
                               setup.target_entropy)
    return setup, steps, step


def test_trainer_update_over_two_trainer_shards_matches_the_jax_step(jax_trainer):
    """Two calls of two gradient steps, 4 rows a trainer shard: the metric
    vector within 1e-5 relative (1e-6 absolute), the health stats within
    1e-4 (1e-6 for the dead fractions), the four trees within 1e-5 and
    Adam's moments within 1e-4 of their scale (the tolerances of
    ``tests/test_torch_parallel_steps.py``); the trainer replicas bitwise
    equal; the player's actor, a module of its own, moves only at the
    hand-off, which copies the actor alone."""
    import test_torch_sac as ts

    from sheeprl_tpu_torch.algos.sac.sac import make_train_step

    setup, steps_1, jax_step = jax_trainer
    trainer_devices = [torch.device("cpu")] * TRAINER_SHARDS
    agent = steps_1.agent
    replicas = replicate(agent, trainer_devices)
    optimizers = [setup.optimizers(r) for r in replicas]
    steps = [make_train_step(r, o, steps_1.cfg, -2.0) for r, o in zip(replicas, optimizers)]
    steps_1.agent, steps_1.optimizers = replicas[0], optimizers[0]
    player = replicate(agent.actor, [torch.device("cpu")] * 2)[1]  # the loop's deep copy
    before, critic_before = _host(state_tensors(player)), _host(state_tensors(replicas[0].critic))
    for call in range(2):
        data = ts.batch(10 + call, b=TRAINER_SHARDS * ts.B)
        keys = ts.jax_keys(20 + call)
        out = jax_step(steps_1.params, steps_1.opt_states, jax.tree_util.tree_map(jnp.asarray, data), keys)
        steps_1.params, steps_1.opt_states = out[0], out[1]
        eps = ts.eps_of(keys)
        metrics = run_shards([step.body(ts.torch_tree(block), eps.clone())
                              for step, block in zip(steps, split(data, TRAINER_SHARDS, 1))])[0].numpy()
        assert replicas_equal([[r, o] for r, o in zip(replicas, optimizers)]), "the trainer replicas diverged"
        np.testing.assert_allclose(metrics[:5], np.asarray(out[2]), rtol=1e-5, atol=1e-6)
        health = dict(zip(steps[0].health_names, metrics[5:]))
        assert sorted(health) == sorted(out[3])
        for k, v in out[3].items():
            tol = 1e-6 if k.endswith("dead_frac") else 1e-4
            np.testing.assert_allclose(health[k], float(v), rtol=tol, atol=tol / 10, err_msg=k)
        steps_1.check_trees()
        steps_1.check_optimizers()
        assert _bitwise(_host(state_tensors(player)), before), "the player moved before the hand-off"
    ppo_decoupled.promote(player, replicas[0].actor)
    assert _bitwise(_host(state_tensors(player)), _host(state_tensors(replicas[0].actor)))
    assert not _bitwise(_host(state_tensors(replicas[0].critic)), critic_before)  # the critic stayed behind


# ---------------------------------------------------------------------------
# the loop


@pytest.mark.parametrize("devices", [2, 3])
def test_the_loop_cuts_each_call_along_axis_1_and_resumes(devices, tmp_path, monkeypatch, bounded):
    """``run exp=sac_decoupled fabric.devices=N``: each train call's
    ``[G, B * trainers, ...]`` batch is cut along axis 1 into the trainer
    shards' blocks; every promotion hands the actor over; the checkpoint
    carries the Ratio, the replay and the global ``batch_size``; a resume
    from the first restores them and trains on."""
    monkeypatch.chdir(tmp_path)
    cuts = []
    stage = sac_module.stage

    def spy(tree, devs, batch_axis=0):
        cuts.append((batch_axis, len(devs), tuple(tree["actions"].shape)))
        return stage(tree, devs, batch_axis=batch_axis)

    with mock.patch.object(sac_module, "stage", spy):
        out = cli.run(RUN + [f"fabric.devices={devices}", "root_dir=port"])
    n = devices - 1
    assert out["trainer_shards"] == n and out["replicas_equal"] and out["gradient_steps"] > 0
    assert cuts and all(axis == 1 and shards == n and shape[1] == 4 * n for axis, shards, shape in cuts)
    assert len(cuts) == len(out["gate"]) == len(out["handoff_ms"]) and all(v for _, v in out["gate"])
    assert np.isfinite(out["metric_rows"]).all()
    assert out["player"] is not out["family"].agent.actor
    assert _bitwise(_host(state_tensors(out["player"])), _host(state_tensors(out["family"].agent.actor)))
    first = out["checkpoints"][0]
    saved = load_state(first)
    assert saved["batch_size"] == 4 * n and "ratio" in saved and saved["rb"] is not None
    assert set(saved["opt_states"]) == {"actor", "critic", "alpha"}
    again = cli.run(RUN + [f"fabric.devices={devices}", "root_dir=resumed", f"checkpoint.resume_from={first}"])
    assert again["start_iter"] == saved["iter_num"] + 1 and again["gradient_steps"] > 0 and again["replicas_equal"]


def test_a_rejected_promotion_keeps_the_players_actor_and_the_rollback_restores_the_trainer(tmp_path, monkeypatch,
                                                                                            bounded):
    """``nan_grads`` at iteration 6 under the halting sentinel at
    ``fabric.devices=3``: the gate rejects, the player's actor keeps the
    bytes promoted at iteration 5, and the rollback puts every tensor of
    both trainer replicas (actor, critics, targets, ``log_alpha`` and the
    three optimizers' moments and counts) back to iteration 5's copy."""
    monkeypatch.chdir(tmp_path)
    seen = {"player": None, "promoted": {}, "rejected": {}, "refreshed": {}, "restored": []}
    promote, gate = ppo_decoupled.promote, Diagnostics.gate_promotion
    refresh, restore = Diagnostics.refresh_last_good, ppo_decoupled.restore_trainer
    from sheeprl_tpu_torch.algos.sac import sac_decoupled

    def promote_spy(player, trainer):
        seen["player"] = player
        ms = promote(player, trainer)
        seen["promoted"][seen["iter"]] = _host(state_tensors(player))
        return ms

    def gate_spy(self, iter_num, *args, **kwargs):
        seen["iter"] = iter_num
        verdict = gate(self, iter_num, *args, **kwargs)
        if not verdict:
            seen["rejected"][iter_num] = _host(state_tensors(seen["player"]))
        return verdict

    def refresh_spy(self, iter_num, params, opt_state):
        seen["refreshed"][iter_num] = (_host(params), _host(opt_state))
        return refresh(self, iter_num, params, opt_state)

    def restore_spy(shards, restored):
        restore(shards, restored)
        seen["restored"].append([(_host(state_tensors(m)), _host(state_tensors(o))) for m, o in shards])

    with mock.patch.object(sac_decoupled, "promote", promote_spy), \
            mock.patch.object(Diagnostics, "gate_promotion", gate_spy), \
            mock.patch.object(Diagnostics, "refresh_last_good", refresh_spy), \
            mock.patch.object(sac_decoupled, "restore_trainer", restore_spy):
        out = cli.run(RUN + ["fabric.devices=3", "root_dir=gate", *NAN_AT_6, *HALT])
    events = _journal(out["log_dir"])
    (reject,) = [e for e in events if e["event"] == "params_reject"]
    (rollback,) = [e for e in events if e["event"] == "rollback"]
    assert reject["iter_num"] == 6 and reject["reason"] == "nonfinite_update" and reject["staleness"] == 1
    assert rollback["iter_num"] == 6 and rollback["restored_iter"] == 5 and "SentinelHalt" in rollback["error"]
    assert out["rollbacks"] == [6] and sorted(seen["rejected"]) == [6]
    assert _bitwise(seen["rejected"][6], seen["promoted"][5])
    params, opt_state = seen["refreshed"][5]
    (after,) = seen["restored"]
    assert len(after) == 2 and all(_bitwise(p, params) and _bitwise(o, opt_state) for p, o in after)
    assert out["replicas_equal"]
    last_metrics = next(e["metrics"] for e in reversed(events) if e["event"] == "metrics")
    assert last_metrics.get("Telemetry/param_staleness") == 0
    assert events[-1]["event"] == "run_end" and events[-1]["status"] == "completed"


def test_a_trainer_exception_rolls_back_and_a_sampling_failure_is_not_quarantined(tmp_path, monkeypatch, bounded):
    """The quarantine covers the train dispatch: a chaos
    ``trainer_exception`` rolls the trainer back and the run completes; a
    failure of the replay sample raises out of the run with no rollback."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    monkeypatch.chdir(tmp_path)
    out = cli.run(RUN + ["fabric.devices=2", "root_dir=exception", *HALT,
                         "diagnostics.resilience.chaos.schedule=[{iter: 6, fault: trainer_exception}]"])
    events = _journal(out["log_dir"])
    kinds = [e["event"] for e in events]
    assert kinds.index("fault_injection") < kinds.index("rollback") < kinds.index("run_end")
    (rollback,) = [e for e in events if e["event"] == "rollback"]
    assert rollback["restored_iter"] == 5 and "ChaosTrainerError" in rollback["error"]
    assert out["rollbacks"] == [6] and 6 not in [it for it, _ in out["gate"]]

    sample = ReplayBuffer.sample
    calls = []

    def failing(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("replay read failed")
        return sample(self, *args, **kwargs)

    with mock.patch.object(ReplayBuffer, "sample", failing), pytest.raises(OSError, match="replay read failed"):
        cli.run(RUN + ["fabric.devices=2", "root_dir=sampling", "run_name=sampling"])
    (journal,) = Path("logs/runs/sampling").rglob("journal.jsonl")
    events = read_journal(str(journal))
    assert not any(e["event"] == "rollback" for e in events)
    assert [e["status"] for e in events if e["event"] == "run_end"] == ["aborted"]


def test_a_fence_halt_saves_the_last_good_state_with_its_counters(tmp_path, monkeypatch, bounded):
    """The sentinel warns (the NaN update is applied): with
    ``max_staleness=1`` the second rejection escalates; the emergency
    checkpoint holds iteration 5's state, finite, with its counters
    (``ckpt_10_0.ckpt``: 5 iterations of 2 envs), the Ratio and the
    replay."""
    from sheeprl_tpu_torch.resilience.isolation import IsolationHalt
    from sheeprl_tpu_torch.resilience.manifest import newest_verified_checkpoint

    monkeypatch.chdir(tmp_path)
    with pytest.raises(IsolationHalt):
        cli.run(RUN + ["fabric.devices=2", "root_dir=fence", "run_name=fence", "checkpoint.every=1000000",
                       *NAN_AT_6, "diagnostics.resilience.isolation.max_staleness=1"])
    (run_dir,) = Path("logs/runs/fence").glob("*/version_0")
    events = read_journal(str(run_dir / "journal.jsonl"))
    rejects = [e for e in events if e["event"] == "params_reject"]
    assert [r["staleness"] for r in rejects] == [1, 2] and rejects[-1]["escalate"] is True
    (run_end,) = [e for e in events if e["event"] == "run_end"]
    assert run_end["status"] == "halted"
    best, _ = newest_verified_checkpoint(str(run_dir))
    assert best.endswith("ckpt_10_0.ckpt")
    saved = load_state(best)
    assert saved["iter_num"] == 5 and saved["policy_step"] == 10 and saved["batch_size"] == 4
    assert saved["last_log"] <= 10 and saved["last_checkpoint"] <= 10 and "ratio" in saved and saved["rb"] is not None
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(saved["agent"])]
    assert all(np.isfinite(leaf).all() for leaf in leaves if leaf.dtype.kind == "f")


# ---------------------------------------------------------------------------
# checkpoints across packages, the Ratio on resume (one JAX loop)


def test_checkpoints_cross_between_the_packages_and_the_ratio_resumes_as_jax(tmp_path, monkeypatch, bounded):
    """The port's checkpoint at ``fabric.devices=3`` passes the JAX
    ``verify_checkpoint`` with the global ``batch_size``; the JAX loop
    resumed from it takes the same policy steps and train dispatches as the
    port's loop resumed from it (``learning_starts`` and the prefill
    shifted, the Ratio restored); the JAX run's own checkpoint, verified by
    the JAX package, resumes in the port at two and three devices."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.utils import save_configs as jax_save_configs

    monkeypatch.chdir(tmp_path)
    run = RUN + ["fabric.devices=3"]
    out = cli.run(run + ["root_dir=port"])
    first = Path(out["checkpoints"][0])
    saved = load_state(str(first))
    assert saved["batch_size"] == 4 * 2 and saved["iter_num"] == 4
    assert jax_verify_checkpoint(str(first)) == (True, "verified")

    port_resumed = cli.run(run + ["root_dir=port_resumed", f"checkpoint.resume_from={first}"])
    crossing = tmp_path / "crossing" / "version_0"
    (crossing / "checkpoint").mkdir(parents=True)
    jax_save_configs(jax_compose(run + ["root_dir=crossing"]), str(crossing))
    for path in first.parent.glob(first.name + "*"):
        shutil.copy(path, crossing / "checkpoint" / path.name)
    before = set(Path(".").rglob("journal.jsonl"))
    jax_run(run + ["root_dir=jax_resumed", f"checkpoint.resume_from={crossing / 'checkpoint' / first.name}"])
    (journal,) = set(Path(".").rglob("journal.jsonl")) - before
    jax_events, port_events = read_journal(str(journal)), _journal(port_resumed["log_dir"])
    assert _calls(jax_events) == _calls(port_events) and _calls(port_events)["train_step"] > 0
    assert port_resumed["start_iter"] == 5

    jax_ckpts = sorted(journal.parent.rglob("ckpt_*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [p.name for p in jax_ckpts] == [Path(c).name for c in port_resumed["checkpoints"]]
    jax_saved, port_saved = load_state(str(jax_ckpts[0])), load_state(port_resumed["checkpoints"][0])
    for key in ("iter_num", "policy_step", "batch_size", "ratio"):
        assert jax_saved[key] == port_saved[key], key
    assert jax_verify_checkpoint(str(jax_ckpts[0])) == (True, "verified")
    for devices in (2, 3):
        again = cli.run(RUN + [f"fabric.devices={devices}", f"root_dir=from_jax_{devices}",
                               f"checkpoint.resume_from={jax_ckpts[0]}"])
        assert again["start_iter"] == jax_saved["iter_num"] + 1 and again["replicas_equal"]
        assert np.isfinite(again["metric_rows"]).all()
