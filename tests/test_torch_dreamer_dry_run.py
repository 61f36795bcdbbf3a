"""A DreamerV1 or V2 run under ``dry_run=True`` keeps the replay the JAX
loops keep there: 4 rows an env (``sheeprl_tpu/algos/dreamer_v2/
dreamer_v2.py:378``, ``dreamer_v1/dreamer_v1.py:339``), where the JAX
DreamerV3 loop, and so Plan2Explore's, keeps 2.  Both packages' dry runs
(one iteration, one gradient step on sequences of one step) checkpoint the
replay, and the checkpoints hold buffers of the same shapes."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["env=dummy", "env.capture_video=False", "env.screen_size=16", "algo.dense_units=8", "algo.mlp_layers=1",
        "algo.world_model.encoder.cnn_channels_multiplier=2",
        "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
        "algo.world_model.stochastic_size=4", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=1",
        "algo.horizon=3", "env.num_envs=2", "metric.logger=null", "dry_run=True", "fabric.accelerator=cpu",
        "algo.run_test=False", "buffer.checkpoint=True"]
EXPS = {"dreamer_v2": (["algo.world_model.discrete_size=4"], 4), "dreamer_v1": ([], 4)}


def _buffer_shapes(root: str) -> dict:
    (ckpt,) = Path(root).rglob("ckpt_*.ckpt")
    return {k: v.shape for k, v in load_state(str(ckpt))["rb"]["buffers"][0]["buffer"].items()}


@pytest.mark.parametrize("exp", list(EXPS))
def test_a_dry_run_keeps_the_jax_loops_replay(exp, tmp_path, monkeypatch):
    from sheeprl_tpu.cli import run as jax_run

    monkeypatch.chdir(tmp_path)
    extra, rows = EXPS[exp]
    overrides = [f"exp={exp}", *TINY, *extra]
    out = cli.run(overrides + ["root_dir=port"])
    assert out["gradient_steps"] == 1 and np.isfinite(out["metric_rows"]).all()
    jax_run(overrides + ["root_dir=jax"])
    port, jax = _buffer_shapes("logs/runs/port"), _buffer_shapes("logs/runs/jax")
    assert port == jax and port["actions"][0] == rows
