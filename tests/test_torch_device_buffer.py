"""The device replay ring (``buffer.device=True``) against the JAX package's
``DeviceSequentialReplayBuffer``, on CPU tensors: per-env write heads, the
windows one seed draws, the checkpoint's truncation mark, ``state_dict``,
and loading the host buffer's format both ways."""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependentReplayBuffer
from sheeprl_tpu.data.device_buffer import DeviceSequentialReplayBuffer as JaxDeviceSequentialReplayBuffer
from sheeprl_tpu.utils.checkpoint import CheckpointCallback as JaxCheckpointCallback
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer
from sheeprl_tpu_torch.data.factory import make_dreamer_replay_buffer
from sheeprl_tpu_torch.utils.checkpoint import CheckpointCallback, load_state
from sheeprl_tpu_torch.utils.utils import dotdict
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

SIZE, ENVS = 7, 3


def _step(rng, n: int, as_tensor: bool = False):
    step = {
        "rgb": rng.integers(0, 256, (1, n, 3, 4, 4), dtype=np.uint8),
        "actions": rng.normal(size=(1, n, 2)).astype(np.float32),
        "rewards": rng.normal(size=(1, n, 1)).astype(np.float32),
        "terminated": (rng.random((1, n, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((1, n, 1), np.float32),
        "is_first": np.zeros((1, n, 1), np.float32),
    }
    if as_tensor:  # the player's actions arrive as a device tensor
        step["actions"] = torch.from_numpy(step["actions"])
    return step


def _filled_pair(seed: int = 0):
    """Both rings fed the same steps: whole-env steps, and episode-end rows
    to single envs, so the heads advance apart and env 0 wraps."""
    ours, theirs = DeviceSequentialReplayBuffer(SIZE, ENVS), JaxDeviceSequentialReplayBuffer(SIZE, ENVS)
    ours.seed(seed)
    theirs.seed(seed)
    rng = np.random.default_rng(seed + 100)
    for i in range(11):
        step = _step(rng, ENVS, as_tensor=i % 2 == 0)
        ours.add(step)
        theirs.add({k: np.asarray(v) for k, v in step.items()})
        if i % 3 == 1:
            idx = [0] if i % 2 else [0, 2]
            extra = _step(rng, len(idx))
            ours.add(extra, idx)
            theirs.add(extra, idx)
    return ours, theirs


def _assert_state_equal(a, b):
    assert sorted(a["buffer"]) == sorted(b["buffer"])
    for k in a["buffer"]:
        np.testing.assert_array_equal(np.asarray(a["buffer"][k]), np.asarray(b["buffer"][k]), err_msg=k)
    for k in ("pos", "filled", "added"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_add_sample_and_state_match_jax_draw_for_draw():
    ours, theirs = _filled_pair()
    _assert_state_equal(ours.state_dict(), theirs.state_dict())
    assert ours.buffer["rgb"].dtype == torch.uint8  # pixels stay uint8 on the device
    for seq_len, batch in ((1, 5), (3, 4), (SIZE, 2)):
        got = ours.sample(batch, sequence_length=seq_len, n_samples=2)
        want = theirs.sample(batch, sequence_length=seq_len, n_samples=2)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert tuple(g[k].shape) == (seq_len, batch) + tuple(ours.buffer[k].shape[2:])
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=f"{k} T={seq_len}")
    with pytest.raises(ValueError, match="greater than the buffer size"):
        ours.sample(2, sequence_length=SIZE + 1)
    with pytest.raises(KeyError, match="key set"):
        ours.add({"rgb": _step(np.random.default_rng(1), ENVS)["rgb"]})
    empty = DeviceSequentialReplayBuffer(SIZE, ENVS)
    with pytest.raises(ValueError, match="Call 'add' first"):
        empty.sample(1)


def test_64_bit_leaves_are_narrowed_loudly_as_in_jax():
    ring = DeviceSequentialReplayBuffer(SIZE, 1)
    with pytest.warns(UserWarning, match="storing as torch.float32"):
        ring.add({"x": np.zeros((1, 1, 2), np.float64)})
    assert ring.buffer["x"].dtype == torch.float32
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ring.add({"x": np.ones((1, 1, 2), np.float64)})  # only the first add allocates and warns


def test_checkpoint_marks_the_last_row_of_every_env_truncated_in_the_snapshot_only(tmp_path):
    ours, theirs = _filled_pair(1)
    live_before = ours.buffer["truncated"].clone()

    class _Runtime:
        def save(self, path, state):
            from sheeprl_tpu_torch.utils.checkpoint import save_state

            save_state(path, state)

    path = tmp_path / "checkpoint" / "ckpt_1_0.ckpt"
    CheckpointCallback().on_checkpoint_coupled(_Runtime(), str(path), {"iter_num": 1}, replay_buffer=ours)
    saved = load_state(str(path))["rb"]
    _assert_state_equal(saved, JaxCheckpointCallback()._ckpt_rb(theirs))
    assert saved["buffer"]["truncated"].sum() == ENVS
    assert torch.equal(ours.buffer["truncated"], live_before), "the ring on the device was marked too"


def test_host_format_loads_both_ways_and_round_trips():
    ours, theirs = _filled_pair(2)
    host = EnvIndependentReplayBuffer(SIZE, ENVS)
    host.load_state_dict(ours.state_dict())
    jax_host = JaxEnvIndependentReplayBuffer(SIZE, ENVS)
    jax_host.load_state_dict(theirs.state_dict())
    host_state, jax_host_state = host.state_dict(), jax_host.state_dict()
    for a, b in zip(host_state["buffers"], jax_host_state["buffers"]):
        assert (a["pos"], a["full"]) == (b["pos"], b["full"])
        for k in a["buffer"]:
            np.testing.assert_array_equal(a["buffer"][k], b["buffer"][k])

    ring, jax_ring = DeviceSequentialReplayBuffer(SIZE, ENVS), JaxDeviceSequentialReplayBuffer(SIZE, ENVS)
    ring.load_state_dict(host_state)
    jax_ring.load_state_dict(jax_host_state)
    _assert_state_equal(ring.state_dict(), jax_ring.state_dict())
    # back through the host format, every stored row is where it was
    original = ours.state_dict()
    for k in original["buffer"]:
        np.testing.assert_array_equal(ring.state_dict()["buffer"][k], original["buffer"][k])
    np.testing.assert_array_equal(ring.state_dict()["pos"], original["pos"])
    np.testing.assert_array_equal(ring.state_dict()["filled"], original["filled"])
    with pytest.raises(ValueError, match="envs"):
        DeviceSequentialReplayBuffer(SIZE, ENVS + 1).load_state_dict(host_state)


def test_factory_picks_the_ring_on_the_run_device(tmp_path):
    cfg = dotdict({"buffer": {"device": True, "memmap": False}})
    rb, on_device = make_dreamer_replay_buffer(cfg, 2, str(tmp_path), SIZE, "cpu")
    assert on_device and isinstance(rb, DeviceSequentialReplayBuffer) and rb.n_envs == 2
    cfg.buffer.device = False
    rb, on_device = make_dreamer_replay_buffer(cfg, 2, str(tmp_path), SIZE, "cpu")
    assert not on_device and isinstance(rb, EnvIndependentReplayBuffer)
