"""The faults the port's lint found, each held to the JAX package:

* the DreamerV3-family loop drains one metric row a training iteration, as
  the JAX loops do (2 gradient steps an iteration: the same rows behind each
  logged mean, the same ``nonfinite_steps`` in the ``divergence`` events);
* a resume from a directory journals one ``ckpt_skipped`` per rejected
  checkpoint;
* the on-policy loop instruments PPO's and A2C's rollout as
  ``kind="rollout"`` (PPO-recurrent's only its update);
* ``check_configs`` refuses what the JAX ``check_configs`` refuses, with the
  same exception type;
* the evaluation passes its run name to a W&B or MLflow logger, and an
  unknown ``fabric.strategy`` warns.
"""

from __future__ import annotations

import math
import warnings
from collections import Counter
from pathlib import Path

import pytest
import yaml

from sheeprl_tpu_torch import cli
from test_torch_threads import one_torch_thread  # noqa: F401

PACKAGES = ("port", "jax")


def _jax_run(overrides):
    from sheeprl_tpu.cli import run

    return run(overrides)


def _runner(name):
    return cli.run if name == "port" else _jax_run


def _journal(tmp_path: Path, pattern: str):
    from sheeprl_tpu_torch.diagnostics.journal import read_journal

    (path,) = sorted(tmp_path.glob(f"logs/runs/{pattern}/**/journal.jsonl"))
    return read_journal(str(path))


# ---------------------------------------------------------------------------
# one metric row a training iteration
# ---------------------------------------------------------------------------

def _count_aggregated(monkeypatch, records):
    """Both packages' aggregators: per logged interval, how many finite and
    non-finite values of each loss fed its mean."""
    import sheeprl_tpu.utils.metric as jax_metric
    import sheeprl_tpu_torch.utils.metric as port_metric

    for name, module in (("port", port_metric), ("jax", jax_metric)):
        cls = module.MetricAggregator
        update, compute = cls.update, cls.compute
        counts = Counter()

        def spy_update(self, key, value, _update=update, _counts=counts):
            if key.startswith(("Loss/", "Grads/", "State/")):
                _counts[(key, math.isfinite(float(value)))] += 1
            return _update(self, key, value)

        def spy_compute(self, _compute=compute, _counts=counts, _name=name):
            records[_name].append(dict(_counts))
            _counts.clear()
            return _compute(self)

        monkeypatch.setattr(cls, "update", spy_update)
        monkeypatch.setattr(cls, "compute", spy_compute)


def test_dreamer_v3_drains_one_metric_row_an_iteration_at_two_gradient_steps(tmp_path, monkeypatch):
    """A tiny DreamerV3 run in each package, 2 envs at ``replay_ratio=1``:
    2 gradient steps an iteration, ``nan_grads`` at iteration 6 under
    ``sentinel.policy=warn``.  The port's rows are one a training iteration,
    each logged mean is over the same rows in both packages, and the
    ``divergence`` events carry the same ``nonfinite_steps``."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER
    from test_torch_dv3_train import RUN

    overrides = [o for o in RUN if o != "diagnostics=off" and not o.startswith("algo.total_steps")] + [
        "algo.total_steps=24", "algo.replay_ratio=1.0", "algo.run_test=False", "diagnostics.sentinel.enabled=True",
        "diagnostics.sentinel.policy=warn", "diagnostics.resilience.chaos.schedule=[{iter: 6, fault: nan_grads}]",
        "metric.log_every=2"]
    monkeypatch.chdir(tmp_path)
    records = {name: [] for name in PACKAGES}
    _count_aggregated(monkeypatch, records)
    outs = {}
    for name in PACKAGES:
        with pytest.warns(RuntimeWarning, match="non-finite training update"):
            outs[name] = _runner(name)(overrides + [f"root_dir={name}"])
    port = outs["port"]
    assert port["gradient_steps"] >= 2 * port["train_iterations"] - 1 > port["train_iterations"]
    assert port["metric_rows"].shape == (port["train_iterations"], len(METRIC_ORDER))
    assert records["port"] == records["jax"]
    assert any(not finite for interval in records["port"] for (_, finite) in interval)
    divergence = {name: [(e["step"], e["nonfinite_steps"], e["policy"]) for e in _journal(tmp_path, name)
                         if e["event"] == "divergence" and e["kind"] == "nonfinite_update"] for name in PACKAGES}
    # the poisoned weights keep every later interval non-finite: one row each
    assert divergence["port"] == divergence["jax"] and {n for _, n, _ in divergence["port"]} == {1}


# ---------------------------------------------------------------------------
# ckpt_skipped on resume
# ---------------------------------------------------------------------------

PPO_MLP = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False", "algo.dense_units=8",
           "algo.mlp_layers=1", "algo.encoder.mlp_features_dim=6", "algo.cnn_keys.encoder=[]",
           "algo.mlp_keys.encoder=[state]", "algo.update_epochs=1", "algo.per_rank_batch_size=4",
           "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=4", "metric.logger=null",
           "metric.log_every=8", "buffer.memmap=False", "algo.run_test=False", "seed=3"]


def test_a_resume_past_a_corrupt_checkpoint_journals_the_same_ckpt_skipped_lines(tmp_path, monkeypatch):
    """A PPO run in each package leaves checkpoints at 8, 16 and 24 policy
    steps; the newest is truncated.  Resumed from its run directory (each
    package from its own: a run's archived config names its package's
    optimizer), each picks the one at 16 and its journal holds one
    ``ckpt_skipped`` line for the one at 24, with the same reason."""
    monkeypatch.chdir(tmp_path)
    skipped = {}
    for name in PACKAGES:
        _runner(name)(PPO_MLP + ["algo.total_steps=24", "checkpoint.every=8", f"root_dir={name}",
                                 "run_name=source"])
        (run_dir,) = sorted(tmp_path.glob(f"logs/runs/{name}/source/version_0"))
        ckpts = sorted(run_dir.glob("checkpoint/*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
        assert [p.name for p in ckpts] == ["ckpt_8_0.ckpt", "ckpt_16_0.ckpt", "ckpt_24_0.ckpt"]
        ckpts[-1].write_bytes(ckpts[-1].read_bytes()[:-16])
        _runner(name)(PPO_MLP + ["algo.total_steps=24", "checkpoint.every=8", "run_name=resumed",
                                 f"checkpoint.resume_from={run_dir}"])
        events = _journal(tmp_path, f"{name}/resumed")
        skipped[name] = [(Path(e["path"]).name, e["reason"]) for e in events if e["event"] == "ckpt_skipped"]
    assert skipped["port"] == skipped["jax"] == [("ckpt_24_0.ckpt", skipped["jax"][0][1])]


def test_a_resolution_drops_the_events_an_earlier_one_queued(tmp_path):
    """Events queued by a resolution no journal drained (a diagnostics-off
    run) are cleared by the next one, as in the JAX package."""
    from sheeprl_tpu.resilience import manifest as jax_manifest
    from sheeprl_tpu_torch.resilience import manifest

    for module in (manifest, jax_manifest):
        module.queue_journal_event("ckpt_skipped", path="stale", reason="digest_mismatch")
        with pytest.raises((ValueError, FileNotFoundError)):
            module.resolve_resume_from(str(tmp_path / "missing"))
        assert module.drain_journal_events() == []


# ---------------------------------------------------------------------------
# the on-policy loop's rollout instrument
# ---------------------------------------------------------------------------

A2C_MLP = ["exp=a2c", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False", "algo.dense_units=8",
           "algo.mlp_layers=1", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=4",
           "metric.logger=null", "metric.log_every=8", "buffer.memmap=False", "algo.run_test=False", "seed=3"]
PPO_REC_MLP = ["exp=ppo_recurrent", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False",
               "algo.dense_units=8", "algo.encoder.dense_units=8", "algo.encoder.mlp_features_dim=6",
               "algo.rnn.lstm.hidden_size=8", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]",
               "algo.update_epochs=1", "algo.per_rank_sequence_length=4", "algo.per_rank_num_batches=2",
               "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=8", "metric.logger=null",
               "metric.log_every=16", "buffer.memmap=False", "algo.run_test=False", "seed=3"]


@pytest.mark.parametrize("overrides, rollout", [
    pytest.param(PPO_MLP + ["algo.total_steps=16"], True, id="ppo"),
    pytest.param(A2C_MLP + ["algo.total_steps=16"], True, id="a2c"),
    pytest.param(PPO_REC_MLP + ["algo.total_steps=32"], False, id="ppo_recurrent"),
])
def test_the_on_policy_loop_instruments_the_rollout_as_the_jax_loops(overrides, rollout, tmp_path, monkeypatch):
    """The run's closing ``telemetry_summary`` counts the same instrumented
    calls in both packages (PPO and A2C: one ``policy_step`` a rollout
    step), and FLOPs are counted for the train step alone, once."""
    monkeypatch.chdir(tmp_path)
    summary, costs, recompiles = {}, {}, {}
    for name in PACKAGES:
        _runner(name)(overrides + [f"root_dir={name}"])
        events = _journal(tmp_path, name)
        (closing,) = [e for e in events if e["event"] == "telemetry_summary"]
        summary[name] = closing["instrumented_calls"]
        costs[name] = [e["fn"] for e in events if e["event"] == "telemetry_cost"]
        recompiles[name] = [e["fn"] for e in events if e["event"] == "recompile"]
    assert summary["port"] == summary["jax"]
    assert ("policy_step" in summary["port"]) == rollout
    if rollout:
        steps = int(next(o for o in overrides if o.startswith("algo.total_steps=")).split("=")[1])
        assert summary["port"]["policy_step"] == steps // 2  # one a vector step of the 2 envs
    assert costs["port"] == costs["jax"] == ["train_step"]
    assert recompiles["port"] == recompiles["jax"] == []


# ---------------------------------------------------------------------------
# check_configs
# ---------------------------------------------------------------------------

REFUSED = [
    ["diagnostics.telemetry.http.port=-1"],
    ["diagnostics.telemetry.http.port=70000"],
    ["diagnostics.telemetry.http.port=abc"],
    ["diagnostics.telemetry.http.port=1.5"],
    ["diagnostics.telemetry.watchdog.storm_threshold=0"],
    ["diagnostics.telemetry.watchdog.storm_threshold=-3"],
    ["diagnostics.goodput.watchdog.heartbeat_s=0"],
    ["diagnostics.goodput.watchdog.stall_threshold_s=-1"],
    ["diagnostics.goodput.profile.enabled=True", "diagnostics.goodput.profile.max_ms=5"],
    ["diagnostics.resilience.max_pending_snapshots=0"],
    ["diagnostics.resilience.inject_preempt_iter=0"],
    ["diagnostics.resilience.isolation.max_staleness=0"],
    ["diagnostics.resilience.isolation.retry_budget=-1"],
    ["diagnostics.resilience.isolation.refresh_every=0"],
    ["diagnostics.resilience.chaos.slow_write_s=0"],
    ["diagnostics.resilience.chaos.schedule=[{iter: 1, fault: bogus}]"],
    ["diagnostics.health.confirm=0"],
    ["diagnostics.health.detectors.update_ratio_low=2", "diagnostics.health.detectors.update_ratio_high=1"],
    ["diagnostics.health.detectors.plateau_window=1"],
    ["diagnostics.health.inject_entropy_collapse_iter=3"],
    ["metric.log_level=2"],
    ["matmul_precision=bogus"],
    ["fabric.fsdp=0"],
    ["fabric.fsdp_min_shard_bytes=-1"],
    ["algo.offline.enabled=true"],
    ["exp=dreamer_v3", "algo.rssm_chunks=0"],
    ["exp=dreamer_v3", "algo.rssm_chunks=2", "algo.rssm_chunk_burn_in=-1"],
    ["exp=dreamer_v3", "algo.rssm_chunks=3"],
    ["exp=dreamer_v3", "algo.rssm_chunks=2", "algo.rssm_chunk_burn_in=40"],
    ["exp=dreamer_v3", "algo.offline.enabled=true"],
]


@pytest.mark.parametrize("overrides", [pytest.param(o, id=" ".join(o)) for o in REFUSED])
def test_check_configs_refuses_what_the_jax_check_configs_refuses(overrides):
    """Each value the JAX ``check_configs`` refuses, the port's refuses with
    the same exception type and message, before a log dir exists (its
    ``fabric.fsdp > 1`` refusals: ``tests/test_torch_fsdp.py``)."""
    from sheeprl_tpu.cli import check_configs as jax_check_configs
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.config import compose

    full = ["exp=ppo", "env=dummy"] + overrides
    errors = {}
    for name, check, comp in (("port", cli.check_configs, compose), ("jax", jax_check_configs, jax_compose)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(Exception) as err:
                check(comp(full))
        errors[name] = err.value
    assert type(errors["port"]) is type(errors["jax"])
    # the same knob named first (the port's remedies name its own commands,
    # its numbers may be spelled 0.0 for 0)
    assert str(errors["port"]).split()[:4] == str(errors["jax"]).split()[:4]


def test_an_unknown_fabric_strategy_warns_in_both_packages():
    from sheeprl_tpu.cli import check_configs as jax_check_configs
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.config import compose

    for check, comp in ((cli.check_configs, compose), (jax_check_configs, jax_compose)):
        with pytest.warns(UserWarning, match="Unknown fabric.strategy 'bogus'"):
            check(comp(["exp=ppo", "env=dummy", "fabric.strategy=bogus"]))


# ---------------------------------------------------------------------------
# the evaluation's logger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target, key", [("WandbLogger", "name"), ("MLFlowLogger", "run_name")])
def test_the_evaluation_names_a_wandb_or_mlflow_run_as_the_jax_evaluation(target, key, tmp_path, monkeypatch):
    """An archived W&B or MLflow logger has no ``name``: the evaluation
    passes ``<run>_evaluation`` as the backend's own run-name keyword, in
    both packages."""
    import sheeprl_tpu.cli as jax_cli
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.config import compose

    seen = {}
    for name, module, comp in (("port", cli, compose), ("jax", jax_cli, jax_compose)):
        run = tmp_path / name / "run"
        (run / "checkpoint").mkdir(parents=True)
        archived = comp(["exp=ppo", "env=dummy"]).as_dict()
        archived["metric"]["logger"] = {"_target_": f"some.backend.{target}", "project": "p"}
        (run / "config.yaml").write_text(yaml.safe_dump(archived))
        monkeypatch.setattr(module, "eval_algorithm", lambda c, _n=name: seen.__setitem__(_n, c))
        module.evaluation([f"checkpoint_path={run / 'checkpoint' / 'ckpt_8_0.ckpt'}", "fabric.accelerator=cpu"])
    assert seen["port"].metric.logger[key] == seen["jax"].metric.logger[key] == "run_evaluation"
    assert [seen[n].env.num_envs for n in PACKAGES] == [1, 1]
