"""Two-shard runs of the port's loops against the JAX loops on two virtual
CPU devices, and their checkpoints across shard counts and packages.

For DreamerV3, PPO and SAC: a tiny ``run`` at ``fabric.devices=2`` in each
package takes the same policy steps, train dispatches and gradient steps
(read from each run's journal and checkpoints), the port's replicas hold
the same bytes at its end, and its metric rows are one a train dispatch
(PPO, SAC) or one a training iteration (DreamerV3).  The port's two-shard
checkpoint passes the JAX ``verify_checkpoint`` and resumes in the JAX loop
at two devices; the JAX two-device checkpoint resumes in the port at one
shard and at two.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_droq import bounded  # noqa: F401 (a fixture: both packages' continuous dummy env in [-1, 1])
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

COMMON = ["env=dummy", "env.capture_video=False", "fabric.accelerator=cpu", "env.num_envs=2", "metric.logger=null",
          "algo.run_test=False", "seed=3", "env.executor=sync"]
RUNS = {
    "dreamer_v3": ["exp=dreamer_v3", "algo.dense_units=8", "algo.mlp_layers=1",
                   "algo.world_model.recurrent_model.recurrent_state_size=8",
                   "algo.world_model.representation_model.hidden_size=8",
                   "algo.world_model.transition_model.hidden_size=8", "algo.world_model.discrete_size=4",
                   "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]",
                   "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]", "algo.per_rank_batch_size=2",
                   "algo.per_rank_sequence_length=4", "algo.horizon=3", "algo.learning_starts=8",
                   "algo.total_steps=24", "buffer.size=32", "buffer.checkpoint=True", "checkpoint.every=8"],
    "ppo": ["exp=ppo", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.total_steps=48",
            "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]", "algo.dense_units=8", "checkpoint.every=16"],
    "sac": ["exp=sac", "env.id=continuous_dummy", "algo.hidden_size=8", "algo.per_rank_batch_size=4",
            "algo.mlp_keys.encoder=[state]", "algo.learning_starts=8", "algo.total_steps=24", "buffer.size=32",
            "buffer.checkpoint=True", "checkpoint.every=8"],
}


def _journal(log_dir: Path):
    return [json.loads(line) for line in open(log_dir / "journal.jsonl")]


def _calls(events):
    (summary,) = [e for e in events if e["event"] == "telemetry_summary"]
    return summary["instrumented_calls"]


def _jax_run(overrides):
    """A JAX run; the directory of the journal it wrote."""
    from sheeprl_tpu.cli import run as jax_run

    before = set(Path(".").rglob("journal.jsonl"))
    jax_run(overrides)
    (journal,) = set(Path(".").rglob("journal.jsonl")) - before
    return journal.parent


@pytest.mark.parametrize("algo", list(RUNS))
def test_two_shard_runs_match_the_jax_loop_and_checkpoints_cross(algo, tmp_path, monkeypatch, bounded):
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint

    monkeypatch.chdir(tmp_path)
    run = COMMON + RUNS[algo]
    out = cli.run(run + ["fabric.devices=2", "root_dir=port"])
    assert out["shards"] == 2 and out["replicas_equal"]
    jax_dir = _jax_run(run + ["fabric.devices=2", "root_dir=jax"])

    # the same work in both packages
    port_events, jax_events = _journal(Path(out["log_dir"])), _journal(jax_dir)
    assert _calls(port_events) == _calls(jax_events)
    rows = out["train_iterations"] if algo == "dreamer_v3" else _calls(jax_events)["train_step"]
    assert len(out["metric_rows"]) == rows > 0 and np.isfinite(out["metric_rows"]).all()
    if algo == "dreamer_v3":
        assert out["gradient_steps"] == _calls(jax_events)["train_step"]
    port_ckpts = [Path(c) for c in out["checkpoints"]]
    jax_ckpts = sorted(jax_dir.rglob("ckpt_*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [p.name for p in port_ckpts] == [p.name for p in jax_ckpts]
    port_state, jax_state = load_state(str(port_ckpts[-1])), load_state(str(jax_ckpts[-1]))
    for key in ("iter_num", "batch_size", "ratio", "policy_step"):
        if key in jax_state:
            assert port_state[key] == jax_state[key], key
    # the two-shard checkpoint holds one copy of the state (batch_size is
    # the global batch, as the JAX loop writes it)
    assert port_state["batch_size"] == 2 * int(compose_value(run, "algo.per_rank_batch_size"))

    # the port's two-shard checkpoint: verified by the JAX package, resumed
    # by the JAX loop at two devices (a resume reads the run's archived
    # config beside the checkpoint, whose targets are each package's own:
    # the checkpoint and its manifest go beside the JAX run's config)
    assert jax_verify_checkpoint(str(port_ckpts[0])) == (True, "verified")
    crossing = tmp_path / "crossing" / "version_0"
    (crossing / "checkpoint").mkdir(parents=True)
    shutil.copy(jax_dir / "config.yaml", crossing / "config.yaml")
    for path in port_ckpts[0].parent.glob(port_ckpts[0].name + "*"):
        shutil.copy(path, crossing / "checkpoint" / path.name)
    resumed = _jax_run(run + ["fabric.devices=2", "root_dir=jax_resumed",
                              f"checkpoint.resume_from={crossing / 'checkpoint' / port_ckpts[0].name}"])
    assert _calls(_journal(resumed))["train_step"] > 0

    # the JAX two-device checkpoint, resumed by the port at one and two shards
    for shards in (1, 2):
        again = cli.run(run + [f"fabric.devices={shards}", f"root_dir=port_resumed_{shards}",
                               f"checkpoint.resume_from={jax_ckpts[0]}"])
        assert again["shards"] == shards and again["replicas_equal"]
        assert again["start_iter"] == load_state(str(jax_ckpts[0]))["iter_num"] + 1
        assert len(again["metric_rows"]) > 0 and np.isfinite(again["metric_rows"]).all()


def compose_value(overrides, dotted):
    from sheeprl_tpu_torch.config import compose

    node = compose(overrides)
    for key in dotted.split("."):
        node = node[key]
    return node
