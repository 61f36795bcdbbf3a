"""The port's dataset export (``sheeprl_tpu_torch/offline/export.py``) held
to the JAX package's (``sheeprl_tpu/offline/export.py``) on the CPU: each
port buffer fed the rows its JAX counterpart is fed (the replay buffer with
and without memmap, wrapped; the sequential buffer with envs out of step and
``rssm_*`` keys; the episode buffer; the device ring), both exported, the
same arrays stream by stream and the same shard layout; incremental export
idempotent and cursor-exact; ``export_run_dir`` on a port run and a JAX
run; the ``export`` command; the checkpoint callback's ``export`` knob; the
async writer's task lane.  Exact: the export is numpy."""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sheeprl_tpu.data import buffers as jax_buffers
from sheeprl_tpu.data.datasets import OfflineDataset as JaxOfflineDataset
from sheeprl_tpu.data.device_buffer import DeviceSequentialReplayBuffer as JaxDeviceBuffer
from sheeprl_tpu.diagnostics.journal import RunJournal as JaxRunJournal
from sheeprl_tpu.offline import export as jax_export
from sheeprl_tpu.resilience.manifest import save_verified_checkpoint as jax_save_verified_checkpoint
from sheeprl_tpu_torch.data import buffers
from sheeprl_tpu_torch.data.datasets import OfflineDataset, discover_shards, read_dataset_meta
from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer
from sheeprl_tpu_torch.offline import export
from sheeprl_tpu_torch.resilience.async_writer import AsyncCheckpointWriter
from sheeprl_tpu_torch.resilience.manifest import save_verified_checkpoint
from sheeprl_tpu_torch.utils.checkpoint import CheckpointCallback
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parents[1]


def _step(rng, n: int, rssm: bool = False, done_every: int = 0, t: int = 0):
    out = {
        "observations": rng.normal(size=(1, n, 4)).astype(np.float32),
        "rgb": rng.integers(0, 256, (1, n, 3, 4, 4), dtype=np.uint8),
        "actions": rng.normal(size=(1, n, 2)).astype(np.float32),
        "rewards": rng.normal(size=(1, n, 1)).astype(np.float32),
        "terminated": np.zeros((1, n, 1), np.float32),
        "truncated": np.zeros((1, n, 1), np.float32),
    }
    if done_every and (t + 1) % done_every == 0:
        out["terminated"][0, 0] = 1  # env 0's episode ends
    if done_every and (t + 1) % (done_every + 2) == 0:
        out["truncated"][0, -1] = 1
    if rssm:
        out["rssm_recurrent"] = rng.normal(size=(1, n, 5)).astype(np.float32)
        out["rssm_valid"] = np.ones((1, n, 1), np.float32)
    return out


def _streams(root: str, package=None) -> dict:
    ds = (OfflineDataset if package is None else JaxOfflineDataset)(root)
    return {seg.stream: (seg.start, ds.gather_window(seg.stream, seg.start, seg.rows)) for seg in ds.segments}


def _same_exports(ours: str, theirs: str) -> int:
    """Both datasets, each opened by its own package: the same streams,
    logical starts, keys, dtypes and arrays; returns the rows."""
    a, b = _streams(ours), _streams(theirs, "jax")
    assert sorted(a) == sorted(b)
    rows = 0
    for stream, (start, arrays) in b.items():
        assert a[stream][0] == start, stream
        assert sorted(a[stream][1]) == sorted(arrays)
        for k, v in arrays.items():
            assert a[stream][1][k].dtype == v.dtype
            np.testing.assert_array_equal(a[stream][1][k], v, err_msg=f"stream {stream} key {k}")
        rows += len(next(iter(arrays.values())))
    names = lambda root: sorted(p.name for p in Path(root).glob("shard-*.npz"))  # noqa: E731
    assert names(ours) == names(theirs)
    return rows


@pytest.mark.parametrize("memmap", [False, True])
def test_the_replay_buffer_exports_as_the_jax_one(tmp_path, memmap):
    """The uniform replay, wrapped twice, exported after each of three fills
    (the last export finds rows that fell out of the ring: a gap)."""
    kwargs = lambda name: dict(memmap=memmap, memmap_dir=str(tmp_path / name / "mm") if memmap else None)  # noqa: E731
    ours = buffers.ReplayBuffer(8, 3, obs_keys=("observations",), **kwargs("port"))
    theirs = jax_buffers.ReplayBuffer(8, 3, obs_keys=("observations",), **kwargs("jax"))
    rng = np.random.default_rng(0)
    for steps in (5, 6, 14):
        for _ in range(steps):
            data = _step(rng, 3)
            ours.add(data)
            theirs.add(data)
        assert ours.added_steps == theirs.added_steps
        got = export.export_buffer(ours, str(tmp_path / "port_ds"), shard_rows=4)
        want = jax_export.export_buffer(theirs, str(tmp_path / "jax_ds"), shard_rows=4)
        assert {k: got[k] for k in ("rows", "shards")} == {k: want[k] for k in ("rows", "shards")}
        _same_exports(str(tmp_path / "port_ds"), str(tmp_path / "jax_ds"))
    assert ours.state_dict()["added"] == theirs.state_dict()["added"] == 25
    assert len(OfflineDataset(str(tmp_path / "port_ds")).segments) == 6  # 3 envs, each cut by the gap


def test_the_sequential_buffer_with_envs_out_of_step_exports_as_the_jax_one(tmp_path):
    """One sub-buffer per env (the Dreamer replay), the reset rows added to
    the done envs only, the stored RSSM states kept: one stream per env."""
    ours = buffers.EnvIndependentReplayBuffer(16, 3, buffer_cls=buffers.SequentialReplayBuffer)
    theirs = jax_buffers.EnvIndependentReplayBuffer(16, 3, buffer_cls=jax_buffers.SequentialReplayBuffer)
    rng = np.random.default_rng(1)
    for t in range(20):
        data = _step(rng, 3, rssm=True)
        ours.add(data)
        theirs.add(data)
        if t % 3 == 1:
            reset = {k: v[:, [0, 2]] for k, v in _step(rng, 3, rssm=True).items()}
            ours.add(reset, [0, 2])
            theirs.add(reset, [0, 2])
    got = export.export_buffer(ours, str(tmp_path / "port_ds"), shard_rows=5)
    jax_export.export_buffer(theirs, str(tmp_path / "jax_ds"), shard_rows=5)
    assert got["rows"] == _same_exports(str(tmp_path / "port_ds"), str(tmp_path / "jax_ds"))
    starts = {s: a for s, (a, _) in _streams(str(tmp_path / "port_ds")).items()}
    assert starts == {0: 11, 1: 4, 2: 11}  # the envs' rings wrapped by different amounts
    assert "rssm_recurrent" in OfflineDataset(str(tmp_path / "port_ds")).keys


def test_the_episode_buffer_exports_one_stream_per_episode_as_the_jax_one(tmp_path):
    ours = buffers.EpisodeBuffer(40, 2, n_envs=2)
    theirs = jax_buffers.EpisodeBuffer(40, 2, n_envs=2)
    rng = np.random.default_rng(2)
    for t in range(36):
        data = _step(rng, 2, done_every=5, t=t)
        ours.add(data)
        theirs.add(data)
        if t == 20:
            export.export_buffer(ours, str(tmp_path / "port_ds"))
            jax_export.export_buffer(theirs, str(tmp_path / "jax_ds"))
    assert ours.episode_ids == theirs.episode_ids and ours.episode_ids[0] > 0  # evictions happened
    export.export_buffer(ours, str(tmp_path / "port_ds"))
    jax_export.export_buffer(theirs, str(tmp_path / "jax_ds"))
    _same_exports(str(tmp_path / "port_ds"), str(tmp_path / "jax_ds"))
    ds = OfflineDataset(str(tmp_path / "port_ds"))
    assert all(seg.start == 0 for seg in ds.segments) and len(ds.streams) >= 8


def test_the_device_ring_exports_as_the_jax_one(tmp_path):
    """The ring (here on the CPU, its storage as on the card): its rows come
    off the device once, per env from the per-env counters, after the ring
    wrapped for one env and not the others."""
    ours = DeviceSequentialReplayBuffer(10, 3, device="cpu")
    theirs = JaxDeviceBuffer(10, 3)
    rng = np.random.default_rng(3)
    for t in range(12):
        data = {k: v for k, v in _step(rng, 3, rssm=True).items() if k != "observations"}
        ours.add(data)
        theirs.add(data)
        if t % 2:
            reset = {k: v[:, [1]] for k, v in data.items()}
            ours.add(reset, [1])
            theirs.add(reset, [1])
        if t == 5:
            export.export_buffer(ours, str(tmp_path / "port_ds"))
            jax_export.export_buffer(theirs, str(tmp_path / "jax_ds"))
    np.testing.assert_array_equal(ours.added_steps, theirs.added_steps)
    assert export.export_buffer(ours, str(tmp_path / "port_ds"))["rows"] > 0
    jax_export.export_buffer(theirs, str(tmp_path / "jax_ds"))
    _same_exports(str(tmp_path / "port_ds"), str(tmp_path / "jax_ds"))
    assert ours.footprint()["dataset_disk"] > 0 and isinstance(ours.buffer["rgb"], torch.Tensor)


def test_incremental_export_is_idempotent_and_cursor_exact(tmp_path):
    rb = buffers.ReplayBuffer(32, 2)
    rng = np.random.default_rng(4)
    for _ in range(6):
        rb.add(_step(rng, 2))
    exporter = export.BufferDatasetExporter(str(tmp_path / "ds"), shard_rows=4)
    assert exporter.export(rb, step=12) == 12
    assert exporter.export(rb, step=12) == 0  # up to date
    assert export.DatasetWriter(str(tmp_path / "ds")).cursor(1) == 6  # recovered from the manifests
    for _ in range(3):
        rb.add(_step(rng, 2))
    assert exporter.export(rb, step=18) == 6
    good, skipped = discover_shards(str(tmp_path / "ds"))
    assert not skipped and [(e["stream"], e["start"], e["rows"]) for e in good] == \
        [(0, 0, 4), (0, 4, 2), (0, 6, 3), (1, 0, 4), (1, 4, 2), (1, 6, 3)]
    # a fresh exporter on the same dataset continues from its cursors
    assert export.export_buffer(rb, str(tmp_path / "ds"))["rows"] == 0
    assert rb.footprint()["dataset_disk"] > 0


def _run_dir(tmp_path, name, rng, save, steps=10):
    """A run dir as a ``buffer.checkpoint=True`` run leaves it: the archived
    config, a journal with the run's identity and rewards, a verified
    checkpoint with the replay; ``save`` is either package's verified save."""
    version = tmp_path / name / "version_0"
    (version / "checkpoint").mkdir(parents=True)
    (version / "config.yaml").write_text(yaml.safe_dump({"algo": {"name": "sac", "mlp_keys": {"encoder": ["state"]}},
                                                         "env": {"id": "continuous_dummy", "num_envs": 2}, "seed": 7}))
    journal = JaxRunJournal(str(version / "journal.jsonl"))
    journal.write("run_start", run_id=f"{name}/version_0", algo="sac", env="continuous_dummy", seed=7)
    journal.write("metrics", step=8, metrics={"Rewards/rew_avg": 1.5})
    journal.write("metrics", step=16, metrics={"Rewards/rew_avg": 2.5})
    journal.close()
    rb = buffers.ReplayBuffer(8, 2)
    for _ in range(steps):
        rb.add(_step(rng, 2))
    save(str(version / "checkpoint" / f"ckpt_{steps * 2}_0.ckpt"),
         {"agent": {"w": np.ones(3, np.float32)}, "rb": rb.state_dict(), "policy_step": steps * 2})
    return tmp_path / name, rb


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_export_run_dir_converts_either_packages_run_as_the_jax_converter(tmp_path, writer):
    rng = np.random.default_rng(5)
    save = save_verified_checkpoint if writer == "port" else jax_save_verified_checkpoint
    run_dir, rb = _run_dir(tmp_path, "run", rng, save)
    got = export.export_run_dir(str(run_dir), out_dir=str(tmp_path / "port_ds"), shard_rows=3)
    want = jax_export.export_run_dir(str(run_dir), out_dir=str(tmp_path / "jax_ds"), shard_rows=3)
    assert {k: got[k] for k in ("rows", "shards", "checkpoint")} == {k: want[k] for k in ("rows", "shards", "checkpoint")}
    assert got["rows"] == 16 == _same_exports(str(tmp_path / "port_ds"), str(tmp_path / "jax_ds"))
    meta, jax_meta = (read_dataset_meta(str(tmp_path / d))["meta"] for d in ("port_ds", "jax_ds"))
    for m in (meta, jax_meta):
        m.pop("source"), m["checkpoint"].pop("path"), m["journal"].pop("path")
    assert meta == jax_meta and meta["journal"]["reward_mean"] == 2.0 and meta["algo"] == "sac"
    # the oldest stored row first: the ring wrapped
    np.testing.assert_array_equal(OfflineDataset(str(tmp_path / "port_ds")).gather_window(0, 0, 8)["actions"],
                                  np.roll(rb.buffer["actions"][:, 0], -rb._pos, axis=0))
    with pytest.raises(FileNotFoundError, match="No verifiable checkpoint"):
        export.export_run_dir(str(tmp_path / "nowhere"))
    save_verified_checkpoint(str(tmp_path / "empty" / "checkpoint" / "ckpt_4_0.ckpt"), {"agent": {}})
    with pytest.raises(ValueError, match="no replay state"):
        export.export_run_dir(str(tmp_path / "empty"))


def test_the_export_command(tmp_path, capsys):
    """``python -m sheeprl_tpu_torch export <run dir>``: the converter's
    ``main`` and the package's entry point reach it; a bad run dir exits 2."""
    run_dir, _ = _run_dir(tmp_path, "run", np.random.default_rng(6), save_verified_checkpoint)
    assert export.main([str(run_dir), "--out", str(tmp_path / "out"), "--shard-rows", "4"]) == 0
    assert "exported 16 steps in 4 shard(s)" in capsys.readouterr().out
    assert export.main([str(tmp_path / "missing")]) == 2
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "export", str(run_dir)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert OfflineDataset(str(run_dir / "dataset")).total_rows == 16


class _Runtime:
    diagnostics = None

    def save(self, path, state):
        save_verified_checkpoint(path, state)


def test_the_checkpoint_callbacks_export_knob(tmp_path):
    """``buffer.export=True``: each coupled save with a replay appends the
    new rows to ``<run dir>/dataset``, the live rows (the save's truncation
    mark undone first), as the JAX callback does; through the resilience
    writer's task lane when the run has one."""
    from sheeprl_tpu.utils.checkpoint import CheckpointCallback as JaxCheckpointCallback

    rng = np.random.default_rng(7)
    ours, theirs = buffers.ReplayBuffer(32, 2), jax_buffers.ReplayBuffer(32, 2)

    class _JaxRuntime:
        diagnostics = None

        def save(self, path, state):
            jax_save_verified_checkpoint(path, state)

    callback, jax_callback = CheckpointCallback(export=True), JaxCheckpointCallback(export=True)
    for steps, saved in ((6, 12), (3, 18)):
        for _ in range(steps):
            data = _step(rng, 2)
            ours.add(data)
            theirs.add(data)
        callback.on_checkpoint_coupled(_Runtime(), str(tmp_path / "port" / "checkpoint" / f"ckpt_{saved}_0.ckpt"),
                                       {"policy_step": saved}, replay_buffer=ours)
        jax_callback.on_checkpoint_coupled(_JaxRuntime(), str(tmp_path / "jax" / "checkpoint" / f"ckpt_{saved}_0.ckpt"),
                                           {"policy_step": saved}, replay_buffer=theirs)
    assert _same_exports(str(tmp_path / "port" / "dataset"), str(tmp_path / "jax" / "dataset")) == 18
    assert not OfflineDataset(str(tmp_path / "port" / "dataset")).gather_window(0, 0, 9)["truncated"].any()
    # through a run's diagnostics: the shards ride the writer thread and the
    # export is journaled
    writer, events = AsyncCheckpointWriter(), []

    class _Diagnostics:
        _cfg = {"algo": {"name": "sac"}, "env": {"id": "x", "num_envs": 2}, "seed": 1}
        resilience = type("R", (), {"_writer": writer})()

        def _journal_event(self, kind, **fields):
            events.append((kind, fields, threading.current_thread().name))

    runtime = _Runtime()
    runtime.diagnostics = _Diagnostics()
    CheckpointCallback(export=True).on_checkpoint_coupled(
        runtime, str(tmp_path / "run" / "checkpoint" / "ckpt_18_0.ckpt"), {}, replay_buffer=ours)
    writer.close()
    assert [(k, f["rows"], f["step"], t) for k, f, t in events] == [("dataset_export", 18, 18, "sheeprl-ckpt-writer")]
    assert read_dataset_meta(str(tmp_path / "run" / "dataset"))["meta"]["algo"] == "sac"
    # without export no dataset appears
    CheckpointCallback().on_checkpoint_coupled(_Runtime(), str(tmp_path / "plain" / "checkpoint" / "ckpt_1_0.ckpt"),
                                               {}, replay_buffer=ours)
    assert not (tmp_path / "plain" / "dataset").exists()


def test_the_async_writers_task_lane(tmp_path):
    """``submit_task`` runs callables on the writer thread, in one FIFO with
    the checkpoint writes, drained by ``close``; a failing task warns and
    the writer goes on; a closed writer refuses."""
    writer = AsyncCheckpointWriter()
    order, done = [], threading.Event()
    writer.submit(str(tmp_path / "ckpt_1_0.ckpt"), {"w": np.ones(4)}, step=1)
    writer.submit_task(lambda: order.append(os.path.isfile(tmp_path / "ckpt_1_0.ckpt")))
    writer.submit_task(lambda: (order.append(threading.current_thread().name), done.set()))
    assert done.wait(timeout=30)
    writer.close()
    assert order == [True, "sheeprl-ckpt-writer"]
    failing = AsyncCheckpointWriter()
    with pytest.warns(RuntimeWarning, match="task failed"):
        failing.submit_task(lambda: 1 / 0)
        deadline = time.monotonic() + 30
        while failing.busy and time.monotonic() < deadline:
            time.sleep(0.01)
    failing.submit_task(lambda: order.append("after"))
    failing.close()
    assert order[-1] == "after"
    with pytest.raises(RuntimeError, match="closed"):
        failing.submit_task(lambda: None)
