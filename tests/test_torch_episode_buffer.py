"""The port's ``EpisodeBuffer`` against the JAX package's on the same adds
and seed: open episodes per env closed on done, the minimum length,
eviction of the oldest episodes, the episodes and starts each seed draws
with ``prioritize_ends`` on and off, ``sample_next_obs``, ``state_dict``
both ways, the restart truncation, and the Dreamer factory's choice."""

from __future__ import annotations

import numpy as np
import pytest

from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer
from sheeprl_tpu_torch.data.factory import make_dreamer_replay_buffer
from sheeprl_tpu_torch.utils.utils import dotdict
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ENVS = 3


def _adds(seed: int, steps: int = 40):
    """Per-step ``[1, ENVS, ...]`` slabs whose episodes end at random, each
    3 to 8 steps long."""
    rng = np.random.default_rng(seed)
    age = np.zeros(ENVS, int)
    out = []
    for t in range(steps):
        age += 1
        done = ((rng.random(ENVS) < 0.25) & (age >= 3)) | (age >= 8)
        trunc = done & (rng.random(ENVS) < 0.3)
        out.append({
            "obs": rng.normal(size=(1, ENVS, 2, 3)).astype(np.float32),
            "actions": rng.normal(size=(1, ENVS, 2)).astype(np.float32),
            "terminated": (done & ~trunc).astype(np.float32).reshape(1, ENVS, 1),
            "truncated": trunc.astype(np.float32).reshape(1, ENVS, 1),
            "is_first": (age == 1).astype(np.float32).reshape(1, ENVS, 1),
        })
        age[done] = 0
    return out


def _pair(size: int, prioritize_ends: bool, seed: int = 0, min_len: int = 3):
    port = EpisodeBuffer(size, min_len, n_envs=ENVS, obs_keys=("obs",), prioritize_ends=prioritize_ends)
    ref = JaxEpisodeBuffer(size, min_len, n_envs=ENVS, obs_keys=("obs",), prioritize_ends=prioritize_ends)
    for step in _adds(seed):
        port.add(step)
        ref.add(step)
    # a two-step add to the first two envs only
    step = _adds(seed + 1, 2)
    both = {k: np.concatenate([s[k][:, :2] for s in step]) for k in step[0]}
    port.add(both, env_idxes=[0, 2])
    ref.add(both, env_idxes=[0, 2])
    return port, ref


def _assert_same_episodes(port, ref):
    assert port._cum_lengths == ref._cum_lengths
    assert len(port.buffer) == len(ref.buffer) and len(port) == len(ref)
    for a, b in zip(port.buffer, ref.buffer):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("prioritize_ends", [False, True])
@pytest.mark.parametrize("size", [200, 24])
def test_the_same_adds_and_seed_store_and_draw_what_the_jax_buffer_does(size, prioritize_ends):
    port, ref = _pair(size, prioritize_ends)
    if size == 24:
        assert ref._episodes_saved > len(ref.buffer)  # some episodes were evicted
    _assert_same_episodes(port, ref)
    port.seed(7)
    ref.seed(7)
    for seq, n, next_obs in ((3, 2, False), (1, 1, True), (2, 3, True)):
        got = port.sample(4, sample_next_obs=next_obs, n_samples=n, sequence_length=seq)
        want = ref.sample(4, sample_next_obs=next_obs, n_samples=n, sequence_length=seq)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape == (n, seq, 4) + want[k].shape[3:]
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_crosses_both_ways_and_sampling_goes_on_alike(tmp_path):
    port, ref = _pair(60, True)
    fresh_port = EpisodeBuffer(60, 3, n_envs=ENVS, obs_keys=("obs",), prioritize_ends=True)
    fresh_ref = JaxEpisodeBuffer(60, 3, n_envs=ENVS, obs_keys=("obs",), prioritize_ends=True)
    fresh_port.load_state_dict(ref.state_dict())
    fresh_ref.load_state_dict(port.state_dict())
    _assert_same_episodes(fresh_port, fresh_ref)
    # the open episodes cross too: the next adds close the same episodes
    for step in _adds(3, 12):
        fresh_port.add(step)
        fresh_ref.add(step)
    _assert_same_episodes(fresh_port, fresh_ref)
    fresh_port.seed(1)
    fresh_ref.seed(1)
    got, want = fresh_port.sample(5, sequence_length=3), fresh_ref.sample(5, sequence_length=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # memory-mapped episodes hold the same
    mapped = EpisodeBuffer(60, 3, n_envs=ENVS, obs_keys=("obs",), memmap=True, memmap_dir=tmp_path / "mm")
    mapped.load_state_dict(port.state_dict())
    _assert_same_episodes(mapped, ref)
    assert mapped.footprint()["disk_bytes"] > 0


def test_length_checks_and_a_restart_truncation():
    with pytest.raises(ValueError, match="greater than zero"):
        EpisodeBuffer(10, 0)
    with pytest.raises(ValueError, match="lower than the buffer size"):
        EpisodeBuffer(2, 3)
    rb = EpisodeBuffer(20, 2, n_envs=1)
    one = {"obs": np.zeros((1, 1, 1), np.float32), "terminated": np.ones((1, 1, 1), np.float32),
           "truncated": np.zeros((1, 1, 1), np.float32), "is_first": np.ones((1, 1, 1), np.float32)}
    with pytest.raises(RuntimeError, match="too short"):
        rb.add(one)
    with pytest.raises(RuntimeError, match="No valid episodes"):
        rb.sample(1, sequence_length=1)
    # an env restarted under an open episode: it ends there, truncated
    rb = EpisodeBuffer(20, 2, n_envs=1)
    open_steps = {k: np.zeros((3, 1, 1), np.float32) for k in one}
    rb.add(open_steps)
    rb.mark_last_truncated(0)
    assert len(rb.buffer) == 1 and rb.buffer[0]["truncated"][-1, 0] == 1 and rb.buffer[0]["terminated"][-1, 0] == 0


def test_the_dreamer_factory_builds_the_episode_buffer_and_refuses_other_types(tmp_path):
    cfg = dotdict({"buffer": dotdict({"memmap": False, "device": False, "prioritize_ends": True})})
    rb, on_device = make_dreamer_replay_buffer(cfg, 2, str(tmp_path), 16, "cpu", "episode",
                                               minimum_episode_length=4, obs_keys=("rgb",))
    assert isinstance(rb, EpisodeBuffer) and not on_device and rb.prioritize_ends
    # the ring samples sequentially only: the host episode buffer, as in JAX
    cfg.buffer.device = True
    with pytest.warns(UserWarning, match="sequential sampling"):
        rb, on_device = make_dreamer_replay_buffer(cfg, 2, str(tmp_path), 16, "cpu", "episode",
                                                   minimum_episode_length=4)
    assert isinstance(rb, EpisodeBuffer) and not on_device
    cfg.buffer.device = False
    rb, _ = make_dreamer_replay_buffer(cfg, 2, str(tmp_path), 16, "cpu")
    assert isinstance(rb, EnvIndependentReplayBuffer)
    with pytest.raises(ValueError, match="Unrecognized buffer type"):
        make_dreamer_replay_buffer(cfg, 2, str(tmp_path), 16, "cpu", "uniform")
