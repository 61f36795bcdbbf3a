"""The port's decoupled PPO (``sheeprl_tpu_torch/algos/ppo/ppo_decoupled.py``)
held to the JAX package's (``sheeprl_tpu/algos/ppo/ppo_decoupled.py``).

- The trainer update: two consecutive updates over the trainer shards of
  ``fabric.devices=3`` (one player, two trainer shards) from converted
  params, each shard's permutations injected from the JAX keys as the JAX
  step folds them, against the JAX ``make_train_step`` over a two-device
  trainer mesh of the virtual CPU devices 1 and 2; the replicas bitwise
  equal after each, the player's own agent untouched until the hand-off.
- The chaos chains of the JAX package's decoupled PPO tests
  (``tests/test_resilience/test_chaos.py``) on the port's CLI, with the same
  asserted fields, and a ``trainer_exception`` drill.
- The gate and the rollback: a rejected promotion leaves the player's
  tensors bitwise unchanged, GAE after it runs on the player's values, and
  a rollback restores the trainer's parameters and optimizer state bitwise.
- Checkpoints across packages (one JAX loop: it resumes from the port's
  checkpoint, and the port resumes from the JAX run's).
- The config refusals of the JAX ``check_configs`` for a decoupled entry.
"""

from __future__ import annotations

import copy
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
from sheeprl_tpu_torch.diagnostics import Diagnostics
from sheeprl_tpu_torch.diagnostics.journal import read_journal
from sheeprl_tpu_torch.parallel.dp import replicas_equal, run_shards, state_tensors
from sheeprl_tpu_torch.parallel.mesh import replicate
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

# the JAX package's PPO_DECOUPLED_TINY (tests/test_resilience/test_chaos.py)
TINY = ["exp=ppo_decoupled", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.capture_video=False",
        "buffer.memmap=False", "metric.log_level=1", "metric.log_every=1", "fabric.devices=2",
        "fabric.accelerator=cpu", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.update_epochs=1",
        "algo.dense_units=8", "algo.mlp_layers=1", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]",
        "algo.run_test=False"]
NAN_AT_2 = ["diagnostics.resilience.chaos.schedule=[{iter: 2, fault: nan_grads}]"]
HALT = ["diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=halt"]
TRAINER_SHARDS = 2


def _events(run_name: str):
    run_dir = Path("logs") / "runs" / "ppo_decoupled" / "discrete_dummy" / run_name
    (journal_path,) = sorted(run_dir.rglob("journal.jsonl"))
    return run_dir, read_journal(str(journal_path))


def _host(tensors):
    return [t.detach().cpu().clone() for t in tensors]


def _bitwise(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the trainer update against the JAX step over a two-device trainer mesh


@pytest.fixture(scope="module")
def jax_trainer():
    """The discrete family's setup (its JAX agent jitted once) and the JAX
    step over the trainer sub-mesh of devices 1..2, compiled once."""
    import test_torch_ppo as tp
    from jax.sharding import Mesh

    from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step

    assert len(jax.devices()) >= 1 + TRAINER_SHARDS
    s = tp._Setup("discrete")
    total_updates = 10
    opt = tp._jax_optimizer(s.jax_cfg, total_updates)
    trainer_mesh = Mesh(np.asarray(jax.devices()[1:1 + TRAINER_SHARDS]), ("data",))
    step = jax_make_train_step(s.jax_agent, opt, copy.deepcopy(s.jax_cfg), trainer_mesh, 2, 4)
    return s, opt, step, total_updates


def test_trainer_update_over_two_trainer_shards_matches_the_jax_step(jax_trainer):
    """Two consecutive updates (2 epochs x 2 minibatches a shard, 8 rows a
    shard): the metrics, health stats, parameters and Adam's state of
    trainer shard 0 agree with the JAX step's within the tolerances of
    ``tests/test_torch_parallel_steps.py`` (``test_torch_ppo._check_update``:
    metrics and parameters 1e-5, Adam's moments 1e-4 of their scale, the
    health stats 1e-4); the trainer replicas hold the same bytes after each;
    the player's agent, a module of its own, moves only at the hand-off."""
    import test_torch_ppo as tp

    from sheeprl_tpu_torch.algos.ppo.ppo import OnPolicyFamily, linear_schedule
    from sheeprl_tpu_torch.algos.ppo.ppo import make_train_step as port_make_train_step
    from sheeprl_tpu_torch.config import instantiate

    s, opt, jax_step, total_updates = jax_trainer
    devices = [torch.device("cpu")] * (1 + TRAINER_SHARDS)  # fabric.devices=3: the player and two trainer shards
    trainer_devices = devices[1:]
    n, mb = 8, 2
    params, opt_state = jax.tree_util.tree_map(jnp.asarray, s.params), opt.init(s.params)
    schedule = linear_schedule(s.cfg.algo.optimizer.learning_rate, 0.0, total_updates)
    agent = tp.build_agent(s.actions_dim, s.continuous, s.cfg, s.obs_space, s.params, "cpu")
    replicas = replicate(agent, trainer_devices)
    optimizers = [instantiate(s.cfg.algo.optimizer)(r.parameters()) for r in replicas]
    steps = [port_make_train_step(r, o, s.cfg, mb, int(s.cfg.algo.per_rank_batch_size), schedule)
             for r, o in zip(replicas, optimizers)]
    player = copy.deepcopy(agent)
    player_ptrs = {t.data_ptr() for t in state_tensors(player)}
    assert not player_ptrs & {t.data_ptr() for r in replicas for t in state_tensors(r)}
    before = _host(state_tensors(player))
    family = OnPolicyFamily()
    for it in range(2):
        data = tp._data(TRAINER_SHARDS * n, s, 10 + it)
        key = jax.random.PRNGKey(20 + it)
        coefs = (0.2 - 0.05 * it, 0.01, 0.5)
        out = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data), key,
                       tuple(jnp.float32(c) for c in coefs))
        params, opt_state = out[0], out[1]
        rows = {k: ({kk: torch.from_numpy(np.ascontiguousarray(vv)) for kk, vv in v.items()} if isinstance(v, dict)
                    else torch.from_numpy(np.ascontiguousarray(v))) for k, v in data.items()}
        bodies = []
        for d, (step, block) in enumerate(zip(steps, family.shard(rows, trainer_devices))):
            k = jax.random.fold_in(key, d)
            perms = [torch.from_numpy(np.array(jax.random.permutation(e, n))) for e in jax.random.split(k, 2)]
            bodies.append(step.body(block, perms, coefs))
        metrics = run_shards(bodies)[0]
        assert replicas_equal([[r, o] for r, o in zip(replicas, optimizers)]), "the trainer replicas diverged"
        tp._check_update(s, jax.tree_util.tree_map(np.asarray, out), replicas[0], optimizers[0], metrics,
                         steps[0].health_names)
        assert _bitwise(_host(state_tensors(player)), before), "the player moved before the hand-off"
    ms = ppo_decoupled.promote(player, replicas[0])
    assert ms >= 0 and _bitwise(_host(state_tensors(player)), _host(state_tensors(replicas[0])))
    assert {t.data_ptr() for t in state_tensors(player)} == player_ptrs  # copied in place


# ---------------------------------------------------------------------------
# the JAX package's chaos chains, on the port's CLI


def test_chaos_nan_drill_survives_decoupled_run_with_verified_checkpoint(tmp_path, monkeypatch):
    """``nan_grads`` at iteration 2 under ``sentinel.policy=halt``:
    ``fault_injection`` -> ``params_reject`` -> ``rollback``, healthy
    promotions after, a clean end and a verified final checkpoint."""
    from sheeprl_tpu_torch.resilience.manifest import newest_verified_checkpoint, verify_checkpoint

    monkeypatch.chdir(tmp_path)
    out = cli.run([*TINY, "run_name=chaos_nan", "algo.total_steps=80", "checkpoint.every=16",
                   "checkpoint.save_last=True", *NAN_AT_2, *HALT])
    run_dir, events = _events("chaos_nan")
    kinds = [e["event"] for e in events]
    (fault,) = [e for e in events if e["event"] == "fault_injection"]
    assert fault["kind"] == "nan_grads" and fault["source"] == "chaos" and fault["iter_num"] == 2
    (reject,) = [e for e in events if e["event"] == "params_reject"]
    assert reject["reason"] == "nonfinite_update" and reject["iter_num"] == 2
    assert reject["staleness"] == 1 and reject["escalate"] is False
    (rollback,) = [e for e in events if e["event"] == "rollback"]
    assert rollback["iter_num"] == 2 and rollback["restored_iter"] == 1
    assert "SentinelHalt" in rollback["error"]
    assert kinds.index("params_reject") > kinds.index("fault_injection")
    assert kinds.index("rollback") > kinds.index("params_reject")
    last_metrics = next(e["metrics"] for e in reversed(events) if e["event"] == "metrics")
    assert last_metrics.get("Telemetry/param_staleness") == 0
    assert events[-1]["event"] == "run_end" and events[-1]["status"] == "completed"
    best, skipped = newest_verified_checkpoint(str(run_dir))
    assert best is not None and skipped == []
    assert verify_checkpoint(best, deep=True) == (True, "verified")
    assert out["gate"] == [(1, True), (2, False), (3, True), (4, True), (5, True)] and out["rollbacks"] == [2]
    assert out["replicas_equal"] and len(out["handoff_ms"]) == 4


def test_same_injection_without_isolation_kills_the_run(tmp_path, monkeypatch):
    """Gate and rollback off: the same injection halts the run."""
    from sheeprl_tpu_torch.diagnostics.sentinel import SentinelHalt

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SentinelHalt):
        cli.run([*TINY, "run_name=chaos_nan_unfenced", "algo.total_steps=80", "checkpoint.every=16", *NAN_AT_2,
                 *HALT, "diagnostics.resilience.isolation.enabled=False"])
    _, events = _events("chaos_nan_unfenced")
    assert not any(e["event"] in ("params_reject", "rollback") for e in events)
    (run_end,) = [e for e in events if e["event"] == "run_end"]
    assert run_end["status"] == "halted"


def test_staleness_exhaustion_halts_with_last_good_emergency_snapshot(tmp_path, monkeypatch):
    """No rollback (the sentinel warns, so the NaN update is applied and
    every later one stays non-finite): with ``max_staleness=1`` the second
    rejection escalates, the run halts with ``IsolationHalt``, and the
    emergency snapshot holds the last-good parameters with the counters of
    iteration 1 (``ckpt_16_0.ckpt``)."""
    from sheeprl_tpu_torch.resilience.isolation import IsolationHalt
    from sheeprl_tpu_torch.resilience.manifest import newest_verified_checkpoint

    monkeypatch.chdir(tmp_path)
    with pytest.raises(IsolationHalt):
        cli.run([*TINY, "run_name=chaos_fence", "algo.total_steps=160", "checkpoint.every=1000000", *NAN_AT_2,
                 "diagnostics.resilience.isolation.max_staleness=1"])
    run_dir, events = _events("chaos_fence")
    rejects = [e for e in events if e["event"] == "params_reject"]
    assert [r["staleness"] for r in rejects] == [1, 2]
    assert rejects[-1]["escalate"] is True
    (finding,) = [e for e in events if e["event"] == "divergence" and e.get("kind") == "param_staleness_exhausted"]
    assert finding["staleness"] == 2 and finding["budget"] == 1
    (run_end,) = [e for e in events if e["event"] == "run_end"]
    assert run_end["status"] == "halted"
    best, _ = newest_verified_checkpoint(str(run_dir))
    assert best is not None
    saved = load_state(best)
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(saved["agent"])
              + jax.tree_util.tree_leaves(saved["opt_state"])]
    assert all(np.isfinite(leaf).all() for leaf in leaves if leaf.dtype.kind == "f")
    assert saved["iter_num"] == 1 and saved["policy_step"] == 16
    assert saved["batch_size"] == 4 * 1
    assert best.endswith("ckpt_16_0.ckpt")


def test_chaos_slow_write_inflates_ckpt_accounting_not_the_run(tmp_path, monkeypatch):
    """``slow_write`` stalls the async writer, not the loop: the run
    completes and the delayed ``ckpt_end`` carries the stall."""
    monkeypatch.chdir(tmp_path)
    cli.run([*TINY, "run_name=chaos_slow", "algo.total_steps=48", "checkpoint.every=16", "checkpoint.save_last=True",
             "diagnostics.resilience.chaos.schedule=[{iter: 1, fault: slow_write}]",
             "diagnostics.resilience.chaos.slow_write_s=0.4"])
    _, events = _events("chaos_slow")
    (fault,) = [e for e in events if e["event"] == "fault_injection"]
    assert fault["kind"] == "slow_write" and fault["source"] == "chaos"
    ends = [e for e in events if e["event"] == "ckpt_end"]
    assert ends and all(e["status"] == "ok" for e in ends)
    assert max(e.get("queued_s", 0.0) for e in ends) >= 0.4
    assert events[-1]["event"] == "run_end" and events[-1]["status"] == "completed"


def test_a_trainer_exception_drill_rolls_back_and_the_drill_judges_it(tmp_path, monkeypatch):
    """``trainer_exception`` at iteration 2 through the drill's own argv
    (the halting sentinel, the pinned run name) on the drill's default
    workload on the CPU: the chain ``fault_injection -> rollback ->
    run_end``, the rollback to iteration 1's state, and the drill's verdict."""
    from sheeprl_tpu_torch.resilience import chaos

    monkeypatch.chdir(tmp_path)
    schedule = chaos.parse_schedule([{"iter": 2, "fault": "trainer_exception"}])
    argv = chaos.drill_argv(schedule, [*chaos.DEFAULT_OVERRIDES, "fabric.accelerator=cpu"])
    out = cli.run(argv[argv.index("run") + 1:])
    verdict = chaos.judge_drill(schedule, 0)
    assert verdict["ok"], verdict
    _, events = _events(chaos.DRILL_RUN_NAME)
    (rollback,) = [e for e in events if e["event"] == "rollback"]
    assert rollback["iter_num"] == 2 and rollback["restored_iter"] == 1 and "ChaosTrainerError" in rollback["error"]
    assert out["rollbacks"] == [2] and [it for it, _ in out["gate"]] == [1, 3, 4, 5, 6]


# ---------------------------------------------------------------------------
# the gate and the rollback


class _Spy:
    """Host copies of the player at each hand-off and at each rejected
    gate, and of the trainer's state at each refresh and after each
    rollback."""

    def __init__(self):
        self.player, self.iter_num = None, None
        self.promoted, self.rejected, self.refreshed, self.restored = {}, {}, {}, []

    def patches(self):
        promote, gate = ppo_decoupled.promote, Diagnostics.gate_promotion
        refresh, restore = Diagnostics.refresh_last_good, ppo_decoupled.restore_trainer
        spy = self

        def promote_spy(player, trainer):
            ms = promote(player, trainer)
            spy.player = player
            spy.promoted[spy.iter_num] = _host(state_tensors(player))
            return ms

        def gate_spy(self, iter_num, *args, **kwargs):
            spy.iter_num = iter_num
            verdict = gate(self, iter_num, *args, **kwargs)
            if not verdict:
                spy.rejected[iter_num] = _host(state_tensors(spy.player))
            return verdict

        def refresh_spy(self, iter_num, params, opt_state):
            spy.refreshed[iter_num] = (_host(params), _host(opt_state))
            return refresh(self, iter_num, params, opt_state)

        def restore_spy(shards, restored):
            restore(shards, restored)
            spy.restored.append([(_host(state_tensors(m)), _host(state_tensors(o))) for m, o in shards])

        return [mock.patch.object(ppo_decoupled, "promote", promote_spy),
                mock.patch.object(Diagnostics, "gate_promotion", gate_spy),
                mock.patch.object(Diagnostics, "refresh_last_good", refresh_spy),
                mock.patch.object(ppo_decoupled, "restore_trainer", restore_spy)]


def _spied_run(overrides):
    spy = _Spy()
    patches = spy.patches()
    for p in patches:
        p.start()
    try:
        out = cli.run(overrides)
    finally:
        for p in patches:
            p.stop()
    return spy, out


def test_a_rejected_promotion_leaves_the_player_bitwise_unchanged(tmp_path, monkeypatch):
    """The player's tensors at iteration 2's rejected gate are bitwise the
    ones promoted at iteration 1, and the hand-off at iteration 3 moves
    them again."""
    monkeypatch.chdir(tmp_path)
    spy, out = _spied_run([*TINY, "run_name=gate", "algo.total_steps=64", "checkpoint.every=0",
                           "checkpoint.save_last=False", *NAN_AT_2, *HALT])
    assert sorted(spy.rejected) == [2] and sorted(spy.promoted) == [1, 3, 4]
    assert _bitwise(spy.rejected[2], spy.promoted[1])
    assert not _bitwise(spy.promoted[3], spy.promoted[1])
    assert all(torch.isfinite(t).all() for t in spy.rejected[2])
    assert out["player"] is spy.player


def test_gae_after_a_rejected_promotion_runs_on_the_players_values(tmp_path, monkeypatch):
    """The sentinel warns (no rollback, the trainer keeps its NaN update,
    the gate keeps it from the player): iteration 3's GAE takes the player's
    value head, so its returns and advantages are finite while the trainer's
    parameters are not."""
    monkeypatch.chdir(tmp_path)
    seen = []
    rollout_data = ppo_decoupled.rollout_data

    def spy(agent, *args, **kwargs):
        data = rollout_data(agent, *args, **kwargs)
        seen.append((agent, data["returns"].clone(), data["advantages"].clone()))
        return data

    with mock.patch.object(ppo_decoupled, "rollout_data", spy):
        out = cli.run([*TINY, "run_name=gae", "algo.total_steps=48", "checkpoint.every=0",
                       "checkpoint.save_last=False", *NAN_AT_2, "diagnostics.sentinel.policy=warn",
                       "diagnostics.resilience.isolation.max_staleness=8"])
    player, (trainer, _) = out["player"], out["trainer"][0]
    assert [verdict for _, verdict in out["gate"]] == [True, False, False] and out["rollbacks"] == []
    assert all(agent is player for agent, _, _ in seen) and len(seen) == 3
    assert not all(torch.isfinite(p).all() for p in trainer.parameters())
    assert all(torch.isfinite(p).all() for p in player.parameters())
    for _, returns, advantages in seen:
        assert torch.isfinite(returns).all() and torch.isfinite(advantages).all()


def test_a_rollback_restores_the_trainers_params_and_optimizer_state_bitwise(tmp_path, monkeypatch):
    """``nan_grads`` under the halting sentinel at ``fabric.devices=3``: the
    NaN update is applied to both trainer replicas, then the rollback puts
    every parameter and every Adam tensor (moments and step counts, so the
    schedule's count too) of each replica back to the bytes the refresh at
    iteration 1 copied."""
    monkeypatch.chdir(tmp_path)
    spy, out = _spied_run([*TINY, "run_name=rollback", "fabric.devices=3", "algo.total_steps=48",
                           "checkpoint.every=0", "checkpoint.save_last=False", "algo.anneal_lr=True", *NAN_AT_2,
                           *HALT])
    assert out["rollbacks"] == [2] and out["trainer_shards"] == 2 and len(spy.restored) == 1
    params, opt_state = spy.refreshed[1]
    assert any(t.dtype == torch.float32 and t.dim() == 0 and float(t) > 0 for t in opt_state)  # Adam's step counts
    for shard_params, shard_opt in spy.restored[0]:
        assert _bitwise(shard_params, params) and _bitwise(shard_opt, opt_state)
    assert out["replicas_equal"]


def test_restore_trainer_puts_back_a_half_stepped_trainer():
    """A failure inside the update can leave one replica stepped and the
    other not: the restore copies every tensor of both back, in place."""
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    replicas = replicate(net, [torch.device("cpu")] * 2)
    optimizers = [torch.optim.Adam(r.parameters(), lr=0.1) for r in replicas]
    for r, o in zip(replicas, optimizers):
        r(torch.ones(1, 3)).sum().backward()
        o.step()
    snapshot = {k: _host(v) for k, v in ppo_decoupled.trainer_state(replicas[0], optimizers[0]).items()}
    replicas[1](torch.ones(1, 3)).sum().backward()
    optimizers[1].step()  # shard 1 stepped, shard 0 not
    ptrs = [t.data_ptr() for r, o in zip(replicas, optimizers) for t in state_tensors([r, o])]
    ppo_decoupled.restore_trainer(list(zip(replicas, optimizers)), snapshot)
    for r, o in zip(replicas, optimizers):
        assert _bitwise(_host(state_tensors(r)), snapshot["params"])
        assert _bitwise(_host(state_tensors(o)), snapshot["opt_state"])
        assert all(p.grad is None for p in r.parameters())
    assert [t.data_ptr() for r, o in zip(replicas, optimizers) for t in state_tensors([r, o])] == ptrs


# ---------------------------------------------------------------------------
# checkpoints across packages (one JAX loop)


def test_checkpoints_cross_between_the_packages(tmp_path, monkeypatch):
    """The port's checkpoint at ``fabric.devices=3`` passes the JAX
    ``verify_checkpoint`` with the global ``batch_size`` (per_rank_batch_size
    x 2 trainers) and resumes in the JAX loop, whose own checkpoints
    (verified by the JAX package too) resume in the port at two and three
    devices."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.utils import save_configs as jax_save_configs

    monkeypatch.chdir(tmp_path)
    run = [*TINY, "algo.total_steps=64", "checkpoint.every=16"]
    out = cli.run(run + ["fabric.devices=3", "root_dir=port"])
    assert out["replicas_equal"] and len(out["checkpoints"]) == 4
    first = Path(out["checkpoints"][0])
    saved = load_state(str(first))
    assert saved["batch_size"] == 4 * 2 and saved["iter_num"] == 1 and saved["policy_step"] == 16
    assert jax_verify_checkpoint(str(first)) == (True, "verified")

    # the JAX loop resumes from it (its run config archived beside it, the
    # JAX package's own targets)
    crossing = tmp_path / "crossing" / "version_0"
    (crossing / "checkpoint").mkdir(parents=True)
    jax_save_configs(jax_compose(run + ["fabric.devices=3", "root_dir=crossing"]), str(crossing))
    for path in first.parent.glob(first.name + "*"):
        shutil.copy(path, crossing / "checkpoint" / path.name)
    before = set(Path(".").rglob("journal.jsonl"))
    jax_run(run + ["fabric.devices=3", "root_dir=jax_resumed",
                   f"checkpoint.resume_from={crossing / 'checkpoint' / first.name}"])
    (journal,) = set(Path(".").rglob("journal.jsonl")) - before
    events = read_journal(str(journal))
    (summary,) = [e for e in events if e["event"] == "telemetry_summary"]
    assert summary["instrumented_calls"]["train_step"] == 3  # iterations 2 to 4
    jax_ckpts = sorted(journal.parent.rglob("ckpt_*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [p.name for p in jax_ckpts] == ["ckpt_32_0.ckpt", "ckpt_48_0.ckpt", "ckpt_64_0.ckpt"]
    assert load_state(str(jax_ckpts[0]))["batch_size"] == 4 * 2
    assert jax_verify_checkpoint(str(jax_ckpts[0])) == (True, "verified")

    # the JAX checkpoint resumes in the port at one trainer and at two
    for devices in (2, 3):
        again = cli.run(run + [f"fabric.devices={devices}", f"root_dir=port_resumed_{devices}",
                               f"checkpoint.resume_from={jax_ckpts[0]}"])
        assert again["start_iter"] == 3 and again["trainer_shards"] == devices - 1 and again["replicas_equal"]
        assert len(again["metric_rows"]) == 2 and np.isfinite(again["metric_rows"]).all()
        assert load_state(again["checkpoints"][-1])["batch_size"] == 4 * (devices - 1)


# ---------------------------------------------------------------------------
# the config refusals


def _jax_check(overrides):
    from sheeprl_tpu.cli import check_configs as jax_check_configs
    from sheeprl_tpu.config import compose as jax_compose

    try:
        jax_check_configs(jax_compose(overrides))
    except Exception as err:  # noqa: BLE001 - the refusal itself is compared
        return type(err), str(err)
    return None


def _port_check(overrides):
    from sheeprl_tpu_torch.config import compose

    try:
        cli.check_configs(compose(overrides))
    except Exception as err:  # noqa: BLE001 - the refusal itself is compared
        return type(err), str(err)
    return None


@pytest.mark.parametrize("exp", ["ppo_decoupled", "sac_decoupled"])
@pytest.mark.parametrize("option", [
    ["fabric.strategy=fsdp"],
    ["fabric.devices=1"],
    ["algo.offline.enabled=true", "algo.offline.dataset_dir=/nowhere"],
    ["fabric.devices=2"],
])
def test_check_configs_holds_a_decoupled_entry_to_the_jax_rules(exp, option):
    """A strategy other than auto|dp|ddp (ValueError), an explicit
    ``fabric.devices`` under 2 (RuntimeError) and offline training
    (ValueError) refuse with the JAX package's types and messages; two
    devices pass."""
    overrides = [f"exp={exp}", "env=dummy", "env.id=" + ("continuous_dummy" if exp == "sac_decoupled" else
                                                          "discrete_dummy"), *option]
    assert _port_check(overrides) == _jax_check(overrides)
    if option != ["fabric.devices=2"]:
        assert _port_check(overrides) is not None


def test_devices_auto_on_one_device_and_a_missing_card_raise(tmp_path, monkeypatch):
    """``fabric.devices=auto`` on the CPU is one device: the loop's own
    check raises (the JAX loop's RuntimeError); without
    ``fabric.accelerator=cpu`` and with no CUDA device the run raises and
    never falls back to the CPU; ``eval`` of a decoupled checkpoint refuses
    it as the JAX CLI does (no evaluation is registered for it)."""
    from sheeprl_tpu.cli import evaluation as jax_evaluation

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=r"Decoupled PPO needs at least 2 devices: 1 player \+ >=1 trainer "
                                           r"\(got fabric.devices=1\)"):
        cli.run([*TINY, "fabric.devices=auto", "algo.total_steps=16"])
    if not torch.cuda.is_available():
        cuda = [o for o in TINY if o != "fabric.accelerator=cpu"]
        with pytest.raises(RuntimeError, match="selects a CUDA device and none is available"):
            cli.run([*cuda, "algo.total_steps=16"])
    out = cli.run([*TINY, "algo.total_steps=16", "checkpoint.every=16", "root_dir=evaluated"])
    ckpt = out["checkpoints"][-1]
    with pytest.raises(ValueError) as port_err:
        cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    with pytest.raises(ValueError) as jax_err:
        jax_evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert str(port_err.value) == str(jax_err.value)
    assert "Evaluation for algorithm 'ppo_decoupled' is not registered" in str(port_err.value)
