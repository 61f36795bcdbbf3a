"""The port's partial-shard checkpoint groups (``fabric.fsdp > 1``) through
the JAX package's ``tests/test_resilience/test_sharded.py`` cases, and
across packages.

The slices are the FSDP rule's on the host tree, the layout is recorded in
every file's manifest group, a group reassembles bit for bit at any axis
size, a torn group is skipped at resume (``incomplete_group``) and refused
by the loader, and ``keep_last`` deletes whole groups.  Across packages: the
two writers lay out the same state alike; a port-written two-part group of
a DreamerV3 run passes the JAX ``verify_checkpoint`` file by file,
reassembles in the JAX ``load_sharded_checkpoint`` and resumes in the JAX
loop at ``fabric.fsdp=2``; the JAX loop's own group then resumes in the
port at ``fabric.fsdp=2``, at two data shards and at one device.
"""

from __future__ import annotations

import json
import os
import shutil
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

from sheeprl_tpu_torch.resilience.coordination import group_status, rank_shard_path, shard_rank
from sheeprl_tpu_torch.resilience.manifest import (drain_journal_events, newest_verified_checkpoint,
                                                   resolve_resume_from, save_verified_checkpoint)
from sheeprl_tpu_torch.resilience.sharded import (is_partial_checkpoint, load_sharded_checkpoint, partial_layout,
                                                  save_sharded_checkpoint)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

OptState = namedtuple("OptState", ["mu", "nu", "count"])

MIN_SHARD = 64


def _state(step: int = 64):
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(32, 16)).astype(np.float32)
    return {
        "params": {
            "dense": {
                "kernel": kernel,  # 2 KiB, dim 32 divisible: sliced
                "bias": rng.normal(size=(16,)).astype(np.float32),  # 64 B: sliced
            },
            # 140 B but no dimension divisible by 2 or 4: whole
            "odd": rng.normal(size=(7, 5)).astype(np.float32),
        },
        # a NamedTuple (optax's states are) keeps its class through the round trip
        "opt_state": OptState(mu=kernel * 0.1, nu=kernel * 0.01, count=np.int64(3)),
        "small": rng.normal(size=(4,)).astype(np.float32),  # 16 B < floor: whole
        "policy_step": step,
    }


def _assert_states_equal(got, want):
    # the port reads a class it does not import as its stand-in, a tuple
    # tagged with the class's name
    opt = got["opt_state"]
    assert isinstance(opt, tuple) and (hasattr(opt, "_fields") or type(opt).qualname.endswith(".OptState"))
    np.testing.assert_array_equal(got["params"]["dense"]["kernel"], want["params"]["dense"]["kernel"])
    np.testing.assert_array_equal(got["params"]["dense"]["bias"], want["params"]["dense"]["bias"])
    np.testing.assert_array_equal(got["params"]["odd"], want["params"]["odd"])
    np.testing.assert_array_equal(opt[0], want["opt_state"].mu)
    np.testing.assert_array_equal(opt[1], want["opt_state"].nu)
    assert int(opt[2]) == int(want["opt_state"].count)
    np.testing.assert_array_equal(got["small"], want["small"])
    assert int(got["policy_step"]) == int(want["policy_step"])


@pytest.mark.parametrize("path", ["run/checkpoint/ckpt_64_0.ckpt", "run/checkpoint/ckpt_64_3.ckpt",
                                  "run/last.ckpt", "run/last.rank0.ckpt", "run/last.rank2.ckpt", "run/model.pt"])
def test_rank_shard_path_and_the_group_records_are_the_jax_ones(path):
    """Both spellings of a shard's path, idempotent (a shard of another rank
    maps to the asked rank, never gains a second marker), and the records."""
    from sheeprl_tpu.resilience import coordination as jax_coordination
    from sheeprl_tpu.resilience import sharded as jax_sharded
    from sheeprl_tpu_torch.resilience.coordination import group_record
    from sheeprl_tpu_torch.resilience.sharded import partial_group_record

    for rank in range(3):
        ours = rank_shard_path(path, rank)
        assert ours == jax_coordination.rank_shard_path(path, rank)
        assert rank_shard_path(ours, rank) == ours and rank_shard_path(ours, 1) == rank_shard_path(path, 1)
    assert group_record(2, 1, 64) == jax_coordination.group_record(2, 1, 64)
    layout = {"a.b": {"shape": [4, 2], "dtype": "float32", "axis": 0, "parts": 2}}
    assert partial_group_record(2, 1, 64, layout) == jax_sharded.partial_group_record(2, 1, 64, layout)


def test_sharded_save_round_trips_bit_identical_and_lays_out_as_the_jax_writer(tmp_path):
    from sheeprl_tpu.resilience.sharded import partial_layout as jax_partial_layout
    from sheeprl_tpu.resilience.sharded import save_sharded_checkpoint as jax_save_sharded_checkpoint

    state = _state()
    path = str(tmp_path / "ckpt_64_0.ckpt")
    result = save_sharded_checkpoint(path, state, axis_size=4, min_shard_bytes=MIN_SHARD)
    assert result["step"] == 64 and result["shards"] == 4
    for rank in range(4):
        assert os.path.isfile(rank_shard_path(path, rank))
        assert shard_rank(rank_shard_path(path, rank)) == rank
    assert group_status(path) == (True, "group_verified")
    assert is_partial_checkpoint(path)

    layout = partial_layout(path)
    assert set(layout) == {"params.dense.kernel", "params.dense.bias", "opt_state[0]", "opt_state[1]"}
    assert layout["params.dense.kernel"] == {"shape": [32, 16], "dtype": "float32", "axis": 0, "parts": 4}
    full_bytes = sum(a.nbytes for a in (state["params"]["dense"]["kernel"], state["opt_state"].mu,
                                        state["opt_state"].nu))
    assert result["bytes_shard0"] < result["bytes"] < 2 * full_bytes  # slices, not four copies

    # the JAX writer slices the same leaves along the same axes
    jax_path = str(tmp_path / "jax" / "ckpt_64_0.ckpt")
    os.makedirs(os.path.dirname(jax_path))
    jax_save_sharded_checkpoint(jax_path, state, axis_size=4, min_shard_bytes=MIN_SHARD)
    assert jax_partial_layout(jax_path) == layout

    _assert_states_equal(load_sharded_checkpoint(path), state)


def test_resharding_across_axis_sizes_is_bit_identical(tmp_path):
    """Written at axis 4, reassembled, written again at axis 2, reassembled:
    the host tree does not depend on the axis size."""
    state = _state()
    p4 = str(tmp_path / "a" / "ckpt_64_0.ckpt")
    os.makedirs(os.path.dirname(p4))
    save_sharded_checkpoint(p4, state, axis_size=4, min_shard_bytes=MIN_SHARD)
    via4 = load_sharded_checkpoint(p4)
    _assert_states_equal(via4, state)

    p2 = str(tmp_path / "b" / "ckpt_64_0.ckpt")
    os.makedirs(os.path.dirname(p2))
    save_sharded_checkpoint(p2, via4, axis_size=2, min_shard_bytes=MIN_SHARD)
    assert partial_layout(p2)["params.dense.kernel"]["parts"] == 2
    _assert_states_equal(load_sharded_checkpoint(p2), state)


def test_runtime_save_load_wires_the_partial_path(tmp_path):
    """``Runtime(fsdp=4).save`` writes a partial group; ``Runtime.load``
    reassembles it at one device and at another axis size."""
    from sheeprl_tpu_torch.parallel.runtime import Runtime

    state = _state()
    path = str(tmp_path / "ckpt_64_0.ckpt")
    rt4 = Runtime(devices=8, accelerator="cpu", fsdp=4, fsdp_min_shard_bytes=MIN_SHARD)
    assert (rt4.world_size, rt4.fsdp) == (8, 4)
    rt4.save(path, state)
    assert is_partial_checkpoint(path) and partial_layout(path)["params.dense.kernel"]["parts"] == 4
    _assert_states_equal(Runtime(devices=1, accelerator="cpu").load(path), state)
    _assert_states_equal(Runtime(devices=4, accelerator="cpu", fsdp=2, fsdp_min_shard_bytes=MIN_SHARD).load(path),
                         state)


def test_torn_partial_group_is_skipped_at_resume(tmp_path):
    older = str(tmp_path / "ckpt_32_0.ckpt")
    save_sharded_checkpoint(older, _state(32), axis_size=4, min_shard_bytes=MIN_SHARD)
    newest = str(tmp_path / "ckpt_48_0.ckpt")
    save_sharded_checkpoint(newest, _state(48), axis_size=4, min_shard_bytes=MIN_SHARD)
    os.unlink(rank_shard_path(newest, 2))  # tear the newest group

    best, skipped = newest_verified_checkpoint(str(tmp_path))
    assert best == older
    assert {s["reason"] for s in skipped} == {"incomplete_group"}

    drain_journal_events()
    assert resolve_resume_from(str(tmp_path)) == older
    assert ("ckpt_skipped", {"path": newest, "reason": "incomplete_group"}) in drain_journal_events()

    with pytest.raises(ValueError, match="torn"):
        load_sharded_checkpoint(newest)


def test_save_rejects_degenerate_axis_and_loader_rejects_non_partial(tmp_path):
    with pytest.raises(ValueError, match="axis_size"):
        save_sharded_checkpoint(str(tmp_path / "ckpt_1_0.ckpt"), _state(1), axis_size=1)
    plain = str(tmp_path / "ckpt_8_0.ckpt")
    save_verified_checkpoint(plain, _state(8), step=8)
    assert not is_partial_checkpoint(plain) and shard_rank(plain) is None
    with pytest.raises(ValueError, match="not a partial"):
        load_sharded_checkpoint(plain)
    # resume selection still takes the plain file as any checkpoint
    best, skipped = newest_verified_checkpoint(str(tmp_path))
    assert best == plain and skipped == []


def test_keep_last_pruning_deletes_whole_partial_groups(tmp_path):
    from sheeprl_tpu_torch.utils.checkpoint import PROTECTED_CHECKPOINTS, CheckpointCallback, protect_checkpoint

    ckpt_dir = tmp_path / "checkpoint"
    ckpt_dir.mkdir()
    for step in (16, 32, 48, 64):
        save_sharded_checkpoint(str(ckpt_dir / f"ckpt_{step}_0.ckpt"), _state(step), axis_size=4,
                                min_shard_bytes=MIN_SHARD)
    protected = str(ckpt_dir / "ckpt_16_0.ckpt")
    protect_checkpoint(protected)
    try:
        CheckpointCallback(keep_last=2)._delete_old_checkpoints(ckpt_dir)
    finally:
        PROTECTED_CHECKPOINTS.discard(os.path.abspath(protected))
    # the protected checkpoint's whole group survives, the unprotected older
    # group goes whole, manifests with their files
    survivors = sorted(p.name for p in ckpt_dir.glob("*.ckpt"))
    assert survivors == sorted(f"ckpt_{s}_{r}.ckpt" for s in (16, 48, 64) for r in range(4))
    assert not list(ckpt_dir.glob("ckpt_32_*"))
    for step in (16, 48, 64):
        path = str(ckpt_dir / f"ckpt_{step}_0.ckpt")
        assert group_status(path) == (True, "group_verified")
        _assert_states_equal(load_sharded_checkpoint(path), _state(step))

    # when no kept group verifies, the newest older group that does is spared
    with open(rank_shard_path(str(ckpt_dir / "ckpt_64_0.ckpt"), 3), "ab") as fp:
        fp.write(b"torn")
    CheckpointCallback(keep_last=1)._delete_old_checkpoints(ckpt_dir)
    assert sorted({p.name.split("_")[1] for p in ckpt_dir.glob("*.ckpt")}) == ["48", "64"]


# ---------------------------------------------------------------------------
# across packages: a DreamerV3 run's groups

DV3 = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "fabric.accelerator=cpu", "env.num_envs=2",
       "metric.logger=null", "algo.run_test=False", "seed=3", "env.executor=sync", "algo.dense_units=8",
       "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=8",
       "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
       "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[]",
       "algo.cnn_keys.decoder=[]", "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]",
       "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4", "algo.horizon=3", "algo.learning_starts=8",
       "algo.total_steps=32", "buffer.size=32", "buffer.checkpoint=True", "checkpoint.every=8",
       f"fabric.fsdp_min_shard_bytes={MIN_SHARD}"]
FSDP2 = ["fabric.devices=2", "fabric.fsdp=2"]


def _group(path: Path):
    return sorted(path.parent.glob(path.name.rsplit("_", 1)[0] + "_*.ckpt"))


def test_groups_cross_packages_and_axis_sizes(tmp_path, monkeypatch):
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.resilience.sharded import load_sharded_checkpoint as jax_load_sharded_checkpoint
    from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    out = cli.run(DV3 + FSDP2 + ["root_dir=port"])
    assert out["shards"] == 2 and out["replicas_equal"]
    first = Path(out["checkpoints"][0])
    files = _group(first)
    assert [f.name for f in files] == [first.name, first.name.replace("_0.ckpt", "_1.ckpt")]
    # each file verified by the JAX package, the group reassembled by it
    for f in files:
        assert jax_verify_checkpoint(str(f)) == (True, "verified")
    ours, theirs = cli_state(first), jax_load_sharded_checkpoint(str(first))
    assert sorted(ours) == sorted(theirs)
    assert partial_layout(str(first)) and all(r["parts"] == 2 for r in partial_layout(str(first)).values())
    for key in ("world_model", "actor", "critic", "target_critic"):
        _same_leaves(ours[key], theirs[key])

    # resumed by the JAX loop at fsdp=2 (its archived config beside the group)
    crossing = tmp_path / "crossing" / "version_0"
    (crossing / "checkpoint").mkdir(parents=True)
    jax_save_configs(jax_compose(DV3 + FSDP2 + ["root_dir=crossing"]), str(crossing))
    for f in files:
        for part in f.parent.glob(f.name + "*"):
            shutil.copy(part, crossing / "checkpoint" / part.name)
    before = set(Path(".").rglob("journal.jsonl"))
    jax_run(DV3 + FSDP2 + ["root_dir=jax_resumed", f"checkpoint.resume_from={crossing / 'checkpoint' / first.name}"])
    (journal,) = set(Path(".").rglob("journal.jsonl")) - before
    events = [json.loads(line) for line in open(journal)]
    assert [e for e in events if e["event"] == "fsdp_shard_map"]
    assert any(e["event"] == "telemetry_summary" and e["instrumented_calls"]["train_step"] > 0 for e in events)

    # the JAX loop's own group, resumed by the port at fsdp=2, at two data
    # shards and at one device
    jax_first = sorted(journal.parent.rglob("ckpt_*_0.ckpt"), key=lambda p: int(p.name.split("_")[1]))[0]
    assert is_partial_checkpoint(str(jax_first)) and len(_group(jax_first)) == 2
    for devices, fsdp in ((2, 2), (2, 1), (1, 1)):
        again = cli.run(DV3 + [f"fabric.devices={devices}", f"fabric.fsdp={fsdp}", f"root_dir=port_{devices}_{fsdp}",
                               f"checkpoint.resume_from={jax_first}"])
        assert again["shards"] == devices and again["replicas_equal"]
        assert again["start_iter"] == cli_state(jax_first)["iter_num"] + 1
        assert len(again["metric_rows"]) > 0 and np.isfinite(again["metric_rows"]).all()
        written = Path(again["checkpoints"][-1])
        assert is_partial_checkpoint(str(written)) == (fsdp > 1)


def cli_state(path):
    """A checkpoint's whole tree as the port's runtime reads it."""
    from sheeprl_tpu_torch.parallel.runtime import Runtime

    return Runtime(devices=1, accelerator="cpu").load(str(path))


def _same_leaves(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same_leaves(a[k], b[k], f"{where}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
