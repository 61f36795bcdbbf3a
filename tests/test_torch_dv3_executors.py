"""DreamerV3 through the port's executors and timer on the CPU: the same run
through the synchronous, async and shared-memory executors trains the same
(the executors' trajectories are bit-identical, so are the gradient steps),
logs ``Time/sps_train`` and ``Time/sps_env_interaction`` with the JAX
loop's formulas, and a restarted env's last replay row becomes a
truncation in the device ring as in the JAX ring; the timer and its
``SumMetric`` against the JAX package's."""

from __future__ import annotations

import numpy as np
import pytest

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.metric import SumMetric
from sheeprl_tpu_torch.utils.timer import timer
from test_torch_dv3_train import RUN
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


@pytest.fixture(scope="module")
def sync_run(tmp_path_factory):
    return cli.run(RUN + [f"root_dir={tmp_path_factory.mktemp('sync')}", "diagnostics=off"])


@pytest.mark.parametrize("executor", ["async", "shared_memory"])
def test_dreamer_v3_trains_the_same_through_each_executor(sync_run, tmp_path, executor):
    # time an earlier run in this process left unlogged (a run that stopped
    # between two logs): the run starts from a reset timer
    timer.disabled = False
    timer("Time/env_interaction_time")
    timer.timers["Time/env_interaction_time"].update(1e6)
    out = cli.run(RUN + [f"root_dir={tmp_path}", "diagnostics=off", f"env.executor={executor}"])
    assert out["gradient_steps"] == sync_run["gradient_steps"] > 0
    np.testing.assert_array_equal(out["metric_rows"], sync_run["metric_rows"])
    trained = [m for m in out["logged"] if "Loss/world_model_loss" in m]
    assert trained and all(m["Time/sps_train"] > 0 and m["Time/sps_env_interaction"] > 1.0 for m in trained)


def test_the_timer_metrics_follow_the_switches(tmp_path):
    out = cli.run(RUN + [f"root_dir={tmp_path}", "diagnostics=off", "metric.disable_timer=True"])
    assert out["logged"] and not any(k.startswith("Time/") for m in out["logged"] for k in m)


def test_timer_sums_as_the_jax_timer():
    from sheeprl_tpu.utils.metric import SumMetric as JaxSumMetric

    ours, theirs = SumMetric(), JaxSumMetric()
    for v in (0.25, 1.5, np.float32(2.0)):
        ours.update(v)
        theirs.update(v)
    assert ours.compute() == theirs.compute() == 3.75
    ours.reset()
    assert ours.compute() == 0.0
    timer.reset()
    timer.disabled = False
    with timer("Time/test_block"):
        pass
    with timer("Time/test_block", device=None):
        pass
    assert timer.compute()["Time/test_block"] >= 0.0
    timer.disabled = True
    with timer("Time/test_other"):
        pass
    assert "Time/test_other" not in timer.timers
    timer.disabled = False
    timer.timers.pop("Time/test_block")


def test_device_ring_marks_a_restarted_envs_last_row_as_the_jax_ring():
    import jax.numpy as jnp

    from sheeprl_tpu.data.device_buffer import DeviceSequentialReplayBuffer as JaxRing
    from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer

    ours, theirs = DeviceSequentialReplayBuffer(4, n_envs=2), JaxRing(4, n_envs=2)
    for t in range(5):
        row = {"terminated": np.full((1, 2, 1), t % 2, np.float32), "truncated": np.zeros((1, 2, 1), np.float32),
               "is_first": np.full((1, 2, 1), 1 - t % 2, np.float32)}
        ours.add(row)
        theirs.add({k: jnp.asarray(v) for k, v in row.items()})
    ours.mark_last_truncated(1)
    theirs.mark_last_truncated(1)
    for k in ("terminated", "truncated", "is_first"):
        np.testing.assert_array_equal(ours.buffer[k].numpy(), np.asarray(theirs._buf[k]), err_msg=k)


class _FakeEvent:
    """A CUDA event on a fake clock: ``record`` stamps the clock's time (ms)."""

    clock_ms = 0.0
    synchronized = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.stamp = None

    def record(self, stream=None):
        self.stamp = _FakeEvent.clock_ms

    def synchronize(self):
        _FakeEvent.synchronized += 1

    def elapsed_time(self, end):
        return end.stamp - self.stamp


def test_timer_on_the_card_reads_cuda_events_at_compute(monkeypatch):
    """On a CUDA device the block's time is the span between two events on
    its stream, waited for only in ``compute`` (exact on the fake clock)."""
    import torch

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    device = torch.device("cuda", 0)
    timer.reset()
    timer.disabled = False
    _FakeEvent.clock_ms, _FakeEvent.synchronized = 10.0, 0
    for span_ms in (250.0, 1500.0):
        with timer("Time/test_card", device):
            _FakeEvent.clock_ms += span_ms
    assert _FakeEvent.synchronized == 0 and timer.timers["Time/test_card"].compute() == 0.0
    assert timer.compute()["Time/test_card"] == 1.75
    assert _FakeEvent.synchronized == 2
    with timer("Time/test_card", device):
        _FakeEvent.clock_ms += 4000.0
    timer.reset()  # a pending pair is dropped with the sums
    assert timer.compute()["Time/test_card"] == 0.0
    timer.timers.pop("Time/test_card")
