"""DreamerV1 and V2 take an iteration's gradient steps where their JAX loops
take them: after the env step's results, the reset rows of the envs that
finished an episode and the player's re-initialisation.  From one seed and
one prefill, the first gradient step of each package's loop samples the
same replay rows, in the iteration in which the envs end their first
episode: a loop that sampled before the reset rows reached the replay would
draw from one row fewer an env (the sequential buffer), or from no closed
episode at all (the episode buffer).

The JAX loops leave their buffer's random stream unseeded; the port's seeds
it with ``cfg.seed``, and so the test seeds the JAX buffer too, as the
port's loop does.  The prefill's random actions differ between the
packages (each draws its own), so the actions are the one key not
compared; the dummy env's observations, rewards and flags depend on the
step count alone.  Each loop stops at its first sample, before it builds a
gradient step.
"""

from __future__ import annotations

import numpy as np
import pytest

from sheeprl_tpu_torch import cli
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


class _Sampled(Exception):
    """Raised by the recorded ``sample`` once it has the first draw."""


def _recording(factory, record, seed=None):
    """The replay factory, its buffer's first ``sample`` recorded (the draw
    and, of a sequential buffer, the rows each env holds) and then stopped;
    with ``seed`` the buffer's stream seeded first."""

    def make(*args, **kwargs):
        rb, on_device = factory(*args, **kwargs)
        if seed is not None:
            rb.seed(seed)
        sample = rb.sample

        def first_sample(*a, **k):
            rows = [getattr(b, "_pos", None) for b in rb.buffer]
            record.append(({key: np.array(v) for key, v in sample(*a, **k).items()}, rows))
            raise _Sampled

        rb.sample = first_sample
        return rb, on_device

    return make


# the discrete dummy's episodes end at their 5th step; with 2 envs and
# learning from policy step 8 the first gradient step is owed at iteration
# 5, the one in which both envs end their first episode
TINY = ["env=dummy", "env.id=discrete_dummy", "env.capture_video=False", "env.screen_size=16", "algo.dense_units=8",
        "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
        "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
        "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
        "algo.per_rank_batch_size=3", "algo.per_rank_sequence_length=4", "algo.horizon=3", "algo.learning_starts=8",
        "algo.per_rank_pretrain_steps=1", "algo.replay_ratio=0.5", "algo.total_steps=16", "buffer.size=64",
        "env.num_envs=2", "metric.logger=null", "metric.log_level=0", "checkpoint.every=100000",
        "checkpoint.save_last=False", "algo.run_test=False", "seed=7"]


@pytest.mark.parametrize("exp,buffer_type", [("dreamer_v1", "sequential"), ("dreamer_v2", "sequential"),
                                             ("dreamer_v2", "episode")])
def test_the_first_gradient_step_samples_the_jax_loops_rows(exp, buffer_type, tmp_path, monkeypatch):
    import importlib

    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.data import factory

    monkeypatch.chdir(tmp_path)
    overrides = [f"exp={exp}", *TINY, f"buffer.type={buffer_type}"]
    if exp == "dreamer_v2":
        overrides.append("algo.world_model.discrete_size=4")
    jax_loop = importlib.import_module(f"sheeprl_tpu.algos.{exp}.{exp}")
    jax_rows, port_rows = [], []
    monkeypatch.setattr(jax_loop, "make_dreamer_replay_buffer",
                        _recording(jax_loop.make_dreamer_replay_buffer, jax_rows, seed=7))
    monkeypatch.setattr(factory, "make_dreamer_replay_buffer", _recording(factory.make_dreamer_replay_buffer, port_rows))
    with pytest.raises(_Sampled):
        jax_run(overrides + ["root_dir=jax", "fabric.accelerator=cpu"])
    with pytest.raises(_Sampled):
        cli.run(overrides + ["root_dir=port", "fabric.accelerator=cpu"])
    ((want, jax_held),), ((got, port_held),) = jax_rows, port_rows
    if buffer_type == "sequential":
        # five step rows and the reset row of the episode just closed
        assert port_held == jax_held == [6, 6]
    assert sorted(got) == sorted(want) and got["actions"].shape == want["actions"].shape
    for key in sorted(set(want) - {"actions"}):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
