"""A tiny ``run`` at ``fabric.devices=2`` on the CPU of every coupled family
the data axis took last: DreamerV3-JEPA, Plan2Explore-DV3/DV2/DV1
(exploration, and finetuning from the exploration run's two-shard
checkpoint and replay), DreamerV2 with each buffer type, DreamerV1, the
offline loop for SAC, DroQ and DreamerV3, and DreamerV3 with the replay
ring on the device (``buffer.device=True``, sharded by env).  Each takes a
gradient step over two shards and ends with every replica holding shard
0's bytes; its checkpoints hold the global batch size.  The steps
themselves are held to the JAX package's in
``tests/test_torch_parallel_{dv3_family,dv2_family,offline}.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

import test_torch_offline as to
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_droq import bounded  # noqa: F401 (a fixture: both packages' continuous dummy env in [-1, 1])
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TWO = ["fabric.devices=2", "fabric.accelerator=cpu", "metric.logger=null", "algo.run_test=False", "seed=3"]
WIDTHS = ["env=dummy", "env.capture_video=False", "env.screen_size=16", "algo.dense_units=8", "algo.mlp_layers=1",
          "algo.world_model.encoder.cnn_channels_multiplier=2",
          "algo.world_model.recurrent_model.recurrent_state_size=8",
          "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
          "algo.world_model.stochastic_size=4", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4",
          "algo.horizon=3", "algo.learning_starts=16", "algo.total_steps=32", "algo.replay_ratio=0.5",
          "buffer.size=64", "env.num_envs=2", "env.executor=sync"]
DISCRETE = ["algo.world_model.discrete_size=4"]
ENSEMBLES = ["algo.ensembles.n=3", "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1"]
EXPLORATION = ["buffer.checkpoint=True", "checkpoint.every=16"]
ONLINE = {
    "dreamer_v3_jepa": ["exp=dreamer_v3_jepa_xs", *WIDTHS, *DISCRETE],
    "p2e_dv3_exploration": ["exp=p2e_dv3_exploration", *WIDTHS, *DISCRETE, *ENSEMBLES, *EXPLORATION],
    "dreamer_v2_sequential": ["exp=dreamer_v2", *WIDTHS, *DISCRETE, "buffer.type=sequential"],
    "dreamer_v2_episode": ["exp=dreamer_v2", *WIDTHS, *DISCRETE, "buffer.type=episode"],
    "dreamer_v1": ["exp=dreamer_v1", *WIDTHS],
    "p2e_dv2_exploration": ["exp=p2e_dv2_exploration", *WIDTHS, *DISCRETE, *ENSEMBLES, *EXPLORATION],
    "p2e_dv1_exploration": ["exp=p2e_dv1_exploration", *WIDTHS, *ENSEMBLES, *EXPLORATION],
    "dreamer_v3_device_ring": ["exp=dreamer_v3", *WIDTHS, *DISCRETE, "buffer.device=True"],
}
FINETUNING = {"p2e_dv3_finetuning": "p2e_dv3_exploration", "p2e_dv2_finetuning": "p2e_dv2_exploration",
              "p2e_dv1_finetuning": "p2e_dv1_exploration"}
OFFLINE = ["algo.offline.enabled=true", "algo.total_steps=4", "algo.offline.grad_steps_per_iter=2",
           "checkpoint.every=2"]
CASES = [*ONLINE, *FINETUNING, "offline_sac", "offline_droq", "offline_dreamer_v3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's run, made at its first use (an exploration run is the
    finetuning run's source), in a directory of the module's."""
    root = tmp_path_factory.mktemp("parallel_runs")
    made = {}

    def run(name, overrides):
        if name not in made:
            made[name] = cli.run(overrides + TWO + [f"root_dir={root / name}", f"run_name={name}"])
        return made[name]

    run.root = root
    return run


def _overrides(case, runs):
    if case in ONLINE:
        return ONLINE[case]
    if case in FINETUNING:
        source = runs(FINETUNING[case], ONLINE[FINETUNING[case]])
        return [f"exp={case}", "env=dummy", "env.capture_video=False", "env.executor=sync", "algo.replay_ratio=0.5",
                f"checkpoint.exploration_ckpt_path={source['checkpoints'][-1]}", "buffer.load_from_exploration=True",
                "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4", "algo.learning_starts=8",
                "algo.total_steps=24", "buffer.size=64"]
    algo = case.split("_", 1)[1]
    if algo == "dreamer_v3":
        return to.DV3_TINY + OFFLINE + [f"algo.offline.dataset_dir={to._dataset(runs.root / 'dv3', 'dv3')}"]
    data = to._dataset(runs.root / f"{algo}_data", "sac")
    return to.SAC_TINY + [f"exp={algo}", *OFFLINE, f"algo.offline.dataset_dir={data}"]


@pytest.mark.parametrize("case", CASES)
def test_a_tiny_run_over_two_shards_takes_a_gradient_step_with_equal_replicas(case, runs, bounded, monkeypatch):
    from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer

    monkeypatch.chdir(runs.root)
    sampled = []
    sample = DeviceSequentialReplayBuffer.sample
    monkeypatch.setattr(DeviceSequentialReplayBuffer, "sample",
                        lambda self, *a, **k: sampled.append(self._world) or sample(self, *a, **k))
    out = runs(case, _overrides(case, runs))
    # the ring over the data axis, sharded by env
    assert (case == "dreamer_v3_device_ring") == bool(sampled) and set(sampled) <= {2}
    assert out["shards"] == 2 and out["replicas_equal"]
    assert out["gradient_steps"] > 0 and len(out["metric_rows"]) > 0 and np.isfinite(out["metric_rows"]).all()
    if out["checkpoints"]:
        per_rank = 4 if case in ("offline_sac", "offline_droq") else 2
        assert load_state(out["checkpoints"][-1])["batch_size"] == 2 * per_rank
