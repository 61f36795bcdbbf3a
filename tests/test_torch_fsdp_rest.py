"""FSDP's parameters sharded at rest (``fabric.fsdp > 1``): between steps
each shard's modules hold only their model index's slices of the leaves
the rule cuts, as the JAX ``shard_tree`` places them, on the CPU at a tiny
width.

After an ``fsdp=2`` step of the loop's learner (``shard_learner``) every
cut parameter holds its rest, the leaves the rule keeps whole stay whole,
a shard's parameter bytes are the JAX ``shard_map_summary``'s bytes per
device and the memory monitor's ``Telemetry/params_bytes_per_device``
reads the same; the player's transient gather joins them whole.  Two
consecutive steps from slices at rest still equal the JAX FSDP step on a
``(1, 2)`` mesh and the port's one-device step (``test_torch_fsdp_step``'s
case, its helpers and its JAX build reused).  A checkpoint group written
from the slices resumes in the JAX loop at one device and in the port at
an axis of four.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_dv3_train as dv3
from sheeprl_tpu_torch.parallel.fsdp import leaf_slice, rest_of
from test_torch_fsdp_step import MIN_SHARD, setup, two_fsdp_steps  # noqa: F401  (the module-scoped JAX build)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "fabric.accelerator=cpu", "env.num_envs=2",
        "metric.logger=null", "algo.run_test=False", "seed=3", "env.executor=sync", "algo.dense_units=8",
        "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
        "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[]",
        "algo.cnn_keys.decoder=[]", "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]",
        "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4", "algo.horizon=3",
        f"fabric.fsdp_min_shard_bytes={MIN_SHARD}"]


def _held_bytes(replica) -> int:
    return sum(p.numel() * p.element_size() for m in replica for p in m.parameters())


def _assert_at_rest(replicas, cut, size):
    """Every cut parameter holds its rest (its model index's slice, in the
    rest's own storage); every other parameter is whole and cut nowhere."""
    for d, (replica, params) in enumerate(zip(replicas, cut)):
        assert params, "the rule cut nothing"
        ids = {id(p) for p in params}
        for m in replica:
            for p in m.parameters():
                rest = rest_of(p)
                if id(p) in ids:
                    assert rest.index == d % size and rest.size == size
                    assert p.shape == rest.tensor.shape and p.data_ptr() == rest.tensor.data_ptr()
                else:
                    assert rest is None


def test_between_steps_a_shard_holds_only_its_slices_at_the_jax_rules_bytes(tmp_path):
    from sheeprl_tpu.parallel import fsdp as jax_fsdp
    from sheeprl_tpu.parallel.mesh import make_mesh
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step, shard_learner
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics import build_diagnostics
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.dp import split
    from sheeprl_tpu_torch.parallel.runtime import Runtime

    cfg = compose(TINY + ["fabric.devices=2", "fabric.fsdp=2"])
    with pytest.warns(UserWarning, match="more than one shard"):
        runtime = Runtime(devices=2, fsdp=2, accelerator="cpu", fsdp_min_shard_bytes=MIN_SHARD)
    diag = build_diagnostics(cfg).open(str(tmp_path), device=runtime.device)
    obs_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (10,))})
    agent = build_agent((2,), True, cfg, obs_space, None, "cpu")
    whole = {k: v for k, v in agent.trees().items()}
    replicas, optimizer_sets, moments, step = shard_learner(runtime, cfg, diag, agent, None, make_train_step, True,
                                                            runtime.seed_everything(3))
    cut = [[p for m in replica for p in m.parameters() if rest_of(p) is not None] for replica in replicas]
    _assert_at_rest(replicas, cut, 2)

    rng = np.random.default_rng(4)
    T, B = 4, 4
    batch = {"state": rng.normal(size=(T, B, 10)), "actions": np.clip(rng.normal(size=(T, B, 2)), -1, 1),
             "rewards": rng.normal(size=(T, B, 1)), "terminated": np.zeros((T, B, 1)),
             "is_first": np.zeros((T, B, 1))}
    blocks = split({k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()}, 2, 1)
    moments, metrics = step(moments, blocks, 1.0)
    assert torch.isfinite(metrics).all()
    _assert_at_rest(replicas, cut, 2)

    # the rule's bytes: the JAX summary's parameter bytes per device, and
    # the gauge and the journaled shard map read them
    mesh = make_mesh(n_devices=2, axis_names=("data", "model"), axis_sizes=(1, 2))
    rule = jax_fsdp.shard_map_summary({"params": whole}, mesh, MIN_SHARD)["trees"]["params"]
    assert rule["sharded"] > 0 and rule["bytes_per_device"] < rule["bytes"]
    assert [_held_bytes(r) for r in replicas] == [rule["bytes_per_device"]] * 2
    assert diag.memory.interval_metrics()["Telemetry/params_bytes_per_device"] == float(rule["bytes_per_device"])
    events = [json.loads(line) for line in open(tmp_path / "journal.jsonl")]
    (shard_map,) = [e for e in events if e["event"] == "fsdp_shard_map"]
    assert shard_map["held_bytes_per_device"]["params"] == rule["bytes_per_device"]

    # the player's transient gather: shard 0's modules whole for the block,
    # each cut leaf the row's slices joined, then its rest again
    with step.whole():
        assert _held_bytes(replicas[0]) == rule["bytes"]
        for p, p1 in zip(cut[0], cut[1]):
            rest = rest_of(p)
            assert torch.equal(leaf_slice(p.detach(), rest.axis, 0, 2), rest.tensor)
            assert torch.equal(leaf_slice(p.detach(), rest.axis, 1, 2), rest_of(p1).tensor)
    _assert_at_rest(replicas, cut, 2)
    diag.close()


def test_two_steps_from_slices_at_rest_match_the_jax_fsdp_step_and_the_one_device_step(setup, monkeypatch):
    """``test_torch_fsdp_step``'s two steps, with the rest state checked
    after each: the shards' modules hold only their slices, at the rule's
    bytes."""
    from sheeprl_tpu.parallel import fsdp as jax_fsdp

    want = jax_fsdp.shard_map_summary({"params": setup.params}, setup.mesh, MIN_SHARD)["trees"]["params"]
    seen = []

    def between(replicas, cut):
        _assert_at_rest(replicas, cut, 2)
        seen.append([_held_bytes(r) for r in replicas])

    two_fsdp_steps(setup, monkeypatch, between)
    assert want["bytes_per_device"] < want["bytes"]
    assert seen == [[want["bytes_per_device"]] * 2] * 2


def _group(path: Path):
    return sorted(path.parent.glob(path.name.rsplit("_", 1)[0] + "_*.ckpt"))


def test_a_group_written_from_the_slices_resumes_in_the_jax_loop_and_at_another_axis_size(tmp_path, monkeypatch):
    import shutil

    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.resilience.sharded import load_sharded_checkpoint as jax_load_sharded_checkpoint
    from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.resilience.coordination import group_status
    from sheeprl_tpu_torch.resilience.sharded import is_partial_checkpoint

    monkeypatch.chdir(tmp_path)
    run = TINY + ["algo.learning_starts=8", "algo.total_steps=24", "buffer.size=32", "checkpoint.every=8"]
    out = cli.run(run + ["fabric.devices=2", "fabric.fsdp=2", "root_dir=port"])
    assert out["shards"] == 2 and out["replicas_equal"] and out["gradient_steps"] > 0
    first = Path(out["checkpoints"][0])  # mid-run: a resume has steps left to train
    files = _group(first)
    assert len(files) == 2 and group_status(str(first)) == (True, "group_verified")
    state = jax_load_sharded_checkpoint(str(first))
    for key in ("world_model", "actor", "critic", "target_critic"):
        assert all(np.isfinite(np.asarray(v)).all() for v in dv3._leaves(state[key]).values())

    # the JAX loop at one device, from the port's group
    crossing = tmp_path / "crossing" / "version_0"
    (crossing / "checkpoint").mkdir(parents=True)
    jax_save_configs(jax_compose(run + ["fabric.devices=2", "fabric.fsdp=2", "root_dir=crossing"]), str(crossing))
    for f in files:
        for part in f.parent.glob(f.name + "*"):
            shutil.copy(part, crossing / "checkpoint" / part.name)
    before = set(Path(".").rglob("journal.jsonl"))
    jax_run(run + ["fabric.devices=1", "root_dir=jax_resumed",
                   f"checkpoint.resume_from={crossing / 'checkpoint' / first.name}"])
    (journal,) = set(Path(".").rglob("journal.jsonl")) - before
    events = [json.loads(line) for line in open(journal)]
    assert any(e["event"] == "telemetry_summary" and e["instrumented_calls"]["train_step"] > 0 for e in events)

    # the port at an axis of four, from the same group
    again = cli.run(run + ["fabric.devices=4", "fabric.fsdp=4", "root_dir=port_4",
                           f"checkpoint.resume_from={first}"])
    assert again["shards"] == 4 and again["replicas_equal"]
    assert again["start_iter"] == int(state["iter_num"]) + 1 and np.isfinite(again["metric_rows"]).all()
    assert len(again["metric_rows"]) > 0 and is_partial_checkpoint(again["checkpoints"][-1])
    assert len(_group(Path(again["checkpoints"][-1]))) == 4
