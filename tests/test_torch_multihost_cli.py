"""``python -m sheeprl_tpu_torch run exp=ppo`` over two processes on the CPU
(``fabric.num_nodes=2`` with torchrun's variables, a gloo group on a free
localhost port), with the JAX CLI worker's overrides
(``tests/test_parallel/_multihost_cli_worker.py``) but two iterations in
place of its dry run, so that a resume has one left to train.

The loop-level contracts the JAX worker checks: every rank trains against
rank 0's versioned run dir (exactly one ``version_0``), one tfevents file
and one archived ``config.yaml`` (rank 0's logger); then the coordinated
checkpoint (``resilience/coordination.py::coordinated_save``): a group of
one file a rank at each save, whose manifests the JAX
``verify_checkpoint`` accepts and whose group the JAX single-process
``group_status`` calls complete, the two ranks' parameters bitwise equal;
a two-process resume from it; ``trace_rank1.json`` beside rank 0's trace
under ``diagnostics.trace.all_ranks``.  And the three combinations over
processes the port refuses by name: FSDP, the decoupled loops, the replay
ring on the device.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from test_torch_multihost import spawn_ranks
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

WORKER = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.capture_video=False",
          "buffer.memmap=False", "metric.log_level=1", "metric.log_every=1", "checkpoint.save_last=True",
          "fabric.devices=auto", "fabric.accelerator=cpu", "algo.rollout_steps=8", "algo.per_rank_batch_size=4",
          "algo.update_epochs=1", "algo.dense_units=8", "algo.mlp_layers=1", "algo.mlp_keys.encoder=[state]",
          "algo.cnn_keys.encoder=[]", "root_dir=multihost_cli", "run_name=shared"]
RUN = WORKER + ["fabric.num_nodes=2", "algo.total_steps=32", "checkpoint.every=16", "diagnostics.trace.enabled=True"]


def _cli(overrides):
    return lambda rank: [sys.executable, "-m", "sheeprl_tpu_torch", "run", *overrides]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-process run, then its two-process resume from the first
    group, in one working directory."""
    root = tmp_path_factory.mktemp("multihost_cli")
    out = {"root": root, "train": spawn_ranks(_cli(RUN), str(root))}
    for r, (code, text) in enumerate(out["train"]):
        assert code == 0, f"rank {r}: exit {code}\n{text[-4000:]}"
    base = root / "logs" / "runs" / "multihost_cli" / "shared"
    out["base"] = base
    out["tfevents"] = sorted(str(p.relative_to(base)) for p in base.rglob("events.out.tfevents.*"))
    out["first"] = base / "version_0" / "checkpoint" / "ckpt_16_0.ckpt"
    out["resume"] = spawn_ranks(_cli(RUN + [f"checkpoint.resume_from={out['first']}"]), str(root))
    return out


def test_every_rank_trains_against_rank_0s_run_dir_and_logger(runs):
    base = runs["base"]
    assert sorted(d for d in os.listdir(base) if d.startswith("version_")) == ["version_0", "version_1"]
    # the first run's: one version (the resume made the second), one
    # tfevents file (rank 1 has no logger), one archived config
    assert len(runs["tfevents"]) == 1, runs["tfevents"]
    assert (base / "version_0" / "config.yaml").is_file()
    assert len(list((base / "version_0").glob("*.yaml"))) == 1
    journals = list((base / "version_0").glob("journal*.jsonl"))
    assert [j.name for j in journals] == ["journal.jsonl"]  # the journal is rank 0's
    text = "\n".join(t for _, t in runs["train"])
    assert "rank 0 of 2: shard 0 -> cpu" in text and "rank 1 of 2: shard 1 -> cpu" in text


def test_the_coordinated_group_is_one_file_a_rank_the_jax_package_accepts(runs):
    from sheeprl_tpu.resilience.coordination import group_status as jax_group_status
    from sheeprl_tpu.resilience.manifest import read_manifest as jax_read_manifest
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu_torch.parallel.runtime import Runtime
    from sheeprl_tpu_torch.resilience.coordination import group_status

    ckpt_dir = runs["base"] / "version_0" / "checkpoint"
    assert sorted(p.name for p in ckpt_dir.glob("*.ckpt")) == ["ckpt_16_0.ckpt", "ckpt_16_1.ckpt",
                                                              "ckpt_32_0.ckpt", "ckpt_32_1.ckpt"]
    for step in (16, 32):
        files = [ckpt_dir / f"ckpt_{step}_{r}.ckpt" for r in range(2)]
        for r, f in enumerate(files):
            assert jax_verify_checkpoint(str(f)) == (True, "verified")
            group = jax_read_manifest(str(f))["group"]
            assert group == {"world_size": 2, "rank": r, "group_step": step}
        assert jax_group_status(str(files[0])) == (True, "group_verified")
        assert group_status(str(files[0])) == (True, "group_verified")
        # each rank's file holds its own replica: the same bytes
        states = [Runtime(accelerator="cpu").load(str(f)) for f in files]
        _same(states[0]["agent"], states[1]["agent"])
        _same(states[0]["opt_state"], states[1]["opt_state"])
        assert states[0]["batch_size"] == 2 * 4 and states[0]["policy_step"] == step


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def test_a_two_process_resume_from_the_group_trains_on(runs):
    from sheeprl_tpu_torch.resilience.coordination import group_status
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    for r, (code, text) in enumerate(runs["resume"]):
        assert code == 0, f"resumed rank {r}: exit {code}\n{text[-4000:]}"
    resumed = runs["base"] / "version_1" / "checkpoint"
    last = resumed / "ckpt_32_0.ckpt"
    assert group_status(str(last)) == (True, "group_verified")
    for r in range(2):
        state = load_state(str(resumed / f"ckpt_32_{r}.ckpt"))
        assert state["iter_num"] == 2 and state["policy_step"] == 32
    events = [json.loads(line) for line in open(runs["base"] / "version_1" / "journal.jsonl")]
    assert any(e["event"] == "telemetry_summary" and e["instrumented_calls"]["train_step"] == 1 for e in events)


def test_every_rank_traces_under_all_ranks(runs):
    version = runs["base"] / "version_0"
    assert (version / "trace.json").is_file() and (version / "trace_rank1.json").is_file()
    assert not (version / "trace_rank0.json").exists()
    for name, pid in (("trace.json", 0), ("trace_rank1.json", 1)):
        events = json.loads((version / name).read_text())
        spans = [e for e in events if e.get("ph") == "X"]
        assert spans and all(e["pid"] == pid for e in spans)


REFUSED = {
    "fsdp": (["exp=dreamer_v3", "fabric.devices=2", "fabric.fsdp=2"], "fabric.fsdp=2 over 2 processes.*FSDP across"),
    "decoupled": (["exp=ppo_decoupled", "fabric.devices=2"], "exp=ppo_decoupled over 2 processes.*decoupled"),
    "device_buffer": (["exp=dreamer_v3", "buffer.device=True"], "buffer.device=True over 2 processes.*device replay"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_combinations_not_ported_across_processes_are_refused_by_name(case, monkeypatch, tmp_path):
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    for key, value in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "RANK": "0", "WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(key, value)
    overrides, message = REFUSED[case]
    with pytest.raises(NotImplementedError, match=message) as err:
        cli.run(overrides + ["env=dummy", "fabric.accelerator=cpu", "fabric.num_nodes=2", "metric.logger=null"])
    assert "ROADMAP.md Queue 1" in str(err.value)
