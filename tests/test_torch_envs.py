"""The port's env layer held to the JAX package's on the CPU: the wrappers
(frame stack with dilation, actions and reward as observations, velocity
masking, the time limit and episode statistics) on the same seeded
episodes, the gymnasium path of ``make_env``, and each of the port's three
executors against the JAX executor of the same name, bit for bit: obs,
rewards (their dtype too), terminated, truncated, ``final_obs`` and
``final_info`` with their masks.  Only the episodes' wall-clock seconds
(``final_info.episode.t``) differ, and only their presence is compared.

The JAX package is imported inside the tests: the spawned env workers import
this module to unpickle ``_CrashOnce`` and need nothing else of it."""

from __future__ import annotations

import numpy as np
import pytest

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.env import EnvThunk, make_env, make_env_fns, pipelined_vector_env
from sheeprl_tpu_torch.envs.executor import SharedMemoryVectorEnv, auto_envs_per_worker
from sheeprl_tpu_torch.envs.wrappers import FrameStack, RestartOnException
from sheeprl_tpu_torch.utils.utils import dotdict
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _env_cfg(executor=None, wrapper_id="discrete_dummy", cnn=("rgb",), mlp=("state",), seed=7, num_envs=2,
             **env_overrides):
    env = {
        "id": wrapper_id,
        "num_envs": num_envs,
        "frame_stack": 1,
        "sync_env": True,
        "executor": executor,
        "screen_size": 16,
        "action_repeat": 1,
        "grayscale": False,
        "clip_rewards": False,
        "capture_video": False,
        "frame_stack_dilation": 1,
        "actions_as_observation": {"num_stack": -1, "noop": 0, "dilation": 1},
        "max_episode_steps": None,
        "reward_as_observation": False,
        "wrapper": {"_target_": "sheeprl_tpu.envs.env.get_dummy_env", "id": wrapper_id, "sleep_ms": 0},
    }
    env.update(env_overrides)
    return {"seed": seed, "env": env, "algo": {"cnn_keys": {"encoder": list(cnn)}, "mlp_keys": {"encoder": list(mlp)}}}


def _both(raw):
    from sheeprl_tpu.utils.utils import dotdict as jax_dotdict

    return dotdict(raw), jax_dotdict(raw)


def _actions(space, rng, n=None):
    shape = () if n is None else (n,)
    if isinstance(space, spaces.Discrete) or type(space).__name__ == "Discrete":
        return rng.integers(0, space.n, size=shape)
    if type(space).__name__ == "MultiDiscrete":
        return rng.integers(0, np.asarray(space.nvec), size=shape + tuple(np.asarray(space.nvec).shape))
    return rng.standard_normal(shape + tuple(space.shape)).astype(np.float32)


def _assert_same(a, b, path=""):
    """Bit-identical trees: arrays by value and dtype, dicts by keys; the
    episodes' wall-clock seconds only by presence."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            if k == "t" and path.endswith("episode"):
                continue
            _assert_same(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, np.ndarray) and a.dtype == object:
        assert isinstance(b, np.ndarray) and b.dtype == object and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert (x is None) == (y is None), f"{path}[{i}]"
            if x is not None:
                _assert_same(x, y, f"{path}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{path}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=path)


# (dummy env id, env overrides): the frame-stack ring with dilation, actions
# and reward as observations, a time limit that truncates
WRAPPER_CASES = {
    "frame_stack_dilation": ("discrete_dummy", {"frame_stack": 3, "frame_stack_dilation": 2}),
    "actions_as_obs_discrete": ("discrete_dummy", {"actions_as_observation": {"num_stack": 3, "noop": 0,
                                                                               "dilation": 2}}),
    "actions_as_obs_multidiscrete": ("multidiscrete_dummy", {"actions_as_observation": {"num_stack": 2,
                                                                                        "noop": [1, 0],
                                                                                        "dilation": 1}}),
    "actions_as_obs_continuous_reward": ("continuous_dummy", {
        "actions_as_observation": {"num_stack": 2, "noop": 0.5, "dilation": 1}, "reward_as_observation": True}),
    "time_limit_grayscale_repeat": ("continuous_dummy", {"max_episode_steps": 4, "grayscale": True,
                                                         "action_repeat": 2}),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_wrapped_env_steps_as_the_jax_packages(case):
    """One env of each wrapper stack, seeded episodes with numpy actions:
    every observation, reward, flag and info equal (the JAX package's
    golden wrapper tests, tests/test_envs/test_env_layer.py, run on both)."""
    from sheeprl_tpu.envs.env import make_env as jax_make_env

    env_id, overrides = WRAPPER_CASES[case]
    cfg, jax_cfg = _both(_env_cfg(wrapper_id=env_id, **overrides))
    ours, theirs = make_env(cfg, 3, 0)(), jax_make_env(jax_cfg, 3, 0)()
    assert sorted(ours.observation_space.keys()) == sorted(theirs.observation_space.keys())
    for k in ours.observation_space.keys():
        assert ours.observation_space[k].shape == theirs.observation_space[k].shape, k
    rng = np.random.default_rng(0)
    _assert_same(ours.reset(seed=3)[0], theirs.reset(seed=3)[0], "reset")
    for t in range(14):
        action = _actions(theirs.action_space, rng)
        got, want = ours.step(action), theirs.step(action)
        _assert_same(got[0], want[0], f"obs {t}")
        for g, w, name in zip(got[1:4], want[1:4], ("reward", "terminated", "truncated")):
            assert g == w and type(g) is type(w), f"{name} {t}: {g!r} != {w!r}"
        _assert_same(got[4], want[4], f"info {t}")
        if got[2] or got[3]:
            _assert_same(ours.reset()[0], theirs.reset()[0], f"reset {t}")
    ours.close()
    theirs.close()


@pytest.mark.parametrize("num_stack,dilation", [(1, 1), (3, 1), (2, 2), (3, 4)])
def test_frame_stack_ring_matches_the_deque_oracle(num_stack, dilation):
    """Every ``dilation``-th of the newest ``num_stack * dilation`` frames,
    newest last (the JAX package's oracle test, on the port's ring)."""
    from collections import deque

    class Counting:
        observation_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 4, 4), np.uint8)})
        action_space = spaces.Discrete(2)

        def __init__(self):
            self._t = 0

        def _obs(self):
            return {"rgb": np.full((3, 4, 4), self._t % 256, np.uint8)}

        def reset(self, seed=None, options=None):
            self._t = 0
            return self._obs(), {}

        def step(self, action):
            self._t += 1
            return self._obs(), 0.0, False, False, {}

    env = FrameStack(Counting(), num_stack, ["rgb"], dilation)
    oracle = deque([np.zeros((3, 4, 4), np.uint8)] * (num_stack * dilation), maxlen=num_stack * dilation)
    obs, _ = env.reset()
    np.testing.assert_array_equal(obs["rgb"], np.stack(list(oracle)[dilation - 1::dilation]))
    for t in range(1, 20):
        obs, *_ = env.step(0)
        oracle.append(np.full((3, 4, 4), t % 256, np.uint8))
        np.testing.assert_array_equal(obs["rgb"], np.stack(list(oracle)[dilation - 1::dilation]))


@pytest.mark.parametrize("pixels", [False, True])
def test_gymnasium_env_is_adapted_as_the_jax_package_wraps_it(pixels):
    """``gymnasium.make`` (CartPole-v1, imported inside the thunk): the
    vector observation under the mlp key, or with a cnn key the rendered
    frame through the pixel pipeline (``_RenderPixels``); velocity masking;
    the same seeded episodes as the JAX package's env."""
    from sheeprl_tpu.envs.env import make_env as jax_make_env

    raw = _env_cfg(wrapper_id="CartPole-v1", cnn=("rgb",) if pixels else (), mlp=("state",), mask_velocities=True,
                   wrapper={"_target_": "gymnasium.make", "id": "CartPole-v1", "render_mode": "rgb_array"})
    raw["env"]["id"] = "CartPole-v1"
    cfg, jax_cfg = _both(raw)
    ours, theirs = make_env(cfg, 5, 0)(), jax_make_env(jax_cfg, 5, 0)()
    assert isinstance(ours.action_space, spaces.Discrete) and ours.action_space.n == 2
    assert sorted(ours.observation_space.keys()) == (["rgb", "state"] if pixels else ["state"])
    rng = np.random.default_rng(1)
    _assert_same(ours.reset(seed=5)[0], theirs.reset(seed=5)[0], "reset")
    for t in range(12):
        action = int(rng.integers(0, 2))
        got, want = ours.step(action), theirs.step(action)
        _assert_same(got[0], want[0], f"obs {t}")
        assert got[1:4] == want[1:4]
        assert got[0]["state"][1] == 0.0 and got[0]["state"][3] == 0.0  # the velocities, masked
        if got[2] or got[3]:
            break
    ours.close()
    theirs.close()


def test_capture_video_and_unported_backends_raise():
    # video capture is ported: the dummy env renders no image (it has no
    # render_mode), so the recorder cannot be built and the run's env goes
    # on without video, with the JAX package's warning
    cfg = dotdict(_env_cfg(capture_video=True))
    with pytest.warns(UserWarning, match="Video capture disabled: .*Render mode is None"):
        make_env(cfg, 0, 0, "logs/run", "train")().close()
    make_env(cfg, 0, 0)().close()  # serving's throwaway env records nothing, as in JAX
    # the Atari target is ported: without ale_py gymnasium knows no Atari id
    # and raises as the JAX package's make_env does
    import gymnasium

    atari = {"_target_": "gymnasium.wrappers.AtariPreprocessing",
             "env": {"_target_": "gymnasium.make", "id": "PongNoFrameskip-v4"}}
    with pytest.raises(gymnasium.error.NameNotFound, match="PongNoFrameskip"):
        make_env(dotdict(_env_cfg(wrapper=atari)), 0, 0)()
    # a target neither package has still raises
    with pytest.raises(NotImplementedError, match="not ported"):
        make_env(dotdict(_env_cfg(wrapper={"_target_": "my_envs.Unknown"})), 0, 0)()


def test_env_thunks_pickle_with_the_standard_library():
    import pickle

    cfg = dotdict(_env_cfg(max_episode_steps=3))
    for fn in make_env_fns(cfg) + make_env_fns(cfg, restartable=False):
        clone = pickle.loads(pickle.dumps(fn))
        env = clone()
        assert isinstance(clone if not hasattr(clone, "func") else clone.args[0], EnvThunk)
        assert env.reset(seed=1)[0]["rgb"].shape == (3, 16, 16)
        env.close()


def _rollout(envs, n_steps: int, seed: int):
    """``(reset, [step results])`` of a vector env under numpy actions."""
    rng = np.random.default_rng(seed)
    first = envs.reset(seed=seed)
    steps = []
    for _ in range(n_steps):
        envs.step_async(_actions(envs.single_action_space, rng, envs.num_envs))
        steps.append(envs.step_wait())
    envs.close()
    return first, steps


@pytest.mark.parametrize("executor", ["sync", "async", "shared_memory"])
def test_executor_trajectories_are_bit_identical_to_the_jax_executor(executor):
    """Two continuous dummy envs truncated every 4 steps (one truncation
    each and a restart into the next episode within 6 steps): each port
    executor against the JAX executor of the same name."""
    from sheeprl_tpu.envs.env import make_env_fns as jax_make_env_fns
    from sheeprl_tpu.envs.env import pipelined_vector_env as jax_pipelined_vector_env

    raw = _env_cfg(executor=executor, wrapper_id="continuous_dummy", max_episode_steps=4,
                   envs_per_worker=1 if executor == "shared_memory" else None)
    cfg, jax_cfg = _both(raw)
    got = _rollout(pipelined_vector_env(cfg, make_env_fns(cfg)), 6, 11)
    want = _rollout(jax_pipelined_vector_env(jax_cfg, jax_make_env_fns(jax_cfg)), 6, 11)
    _assert_same(got[0][0], want[0][0], "reset obs")
    _assert_same(got[0][1], want[0][1], "reset infos")
    truncations = 0
    for t, (g, w) in enumerate(zip(got[1], want[1])):
        for i, name in enumerate(("obs", "rewards", "terminated", "truncated", "infos")):
            _assert_same(g[i], w[i], f"step {t} {name}")
        truncations += int(g[3].sum())
    assert truncations == 2 and "final_info" in got[1][3][4] and "_episode" in got[1][3][4]["final_info"]


class _CrashOnce:
    """A discrete dummy env thunk whose env raises at its 3rd step once per
    process (picklable: the spawned worker imports this module)."""

    crashed = False

    def __call__(self):
        from sheeprl_tpu_torch.envs.env import get_dummy_env

        env = get_dummy_env("discrete_dummy")
        step = env.step
        calls = {"n": 0}

        def flaky(action):
            calls["n"] += 1
            if calls["n"] == 3 and not _CrashOnce.crashed:
                _CrashOnce.crashed = True
                raise RuntimeError("simulated crash")
            return step(action)

        env.step = flaky
        return env


def test_restart_on_exception_recovers_a_crashing_env_in_the_shared_memory_executor():
    import functools

    fns = [functools.partial(RestartOnException, _CrashOnce(), wait=0) for _ in range(2)]
    envs = SharedMemoryVectorEnv(fns, envs_per_worker=2)
    try:
        obs, _ = envs.reset(seed=0)
        flags = []
        for _ in range(4):
            obs, rewards, terminated, truncated, infos = envs.step(np.zeros(2, np.int64))
            flags.append(infos.get("_restart_on_exception", np.zeros(2, bool)).copy())
        # env 0 crashed at its third step (the first in the slab to reach it)
        # and came back at its first observation, not done
        assert flags[2].tolist() == [True, False] and not any(f.any() for f in flags[:2] + flags[3:])
        assert obs["state"][0, 0] == 1.0 and obs["state"][1, 0] == 4.0
    finally:
        envs.close()
    assert all(not p.is_alive() for p in envs._processes)
    assert auto_envs_per_worker(1) == 1


def test_pipelined_vector_env_refuses_misuse_as_the_jax_package():
    cfg = dotdict(_env_cfg(executor="sync"))
    envs = pipelined_vector_env(cfg, make_env_fns(cfg))
    envs.reset(seed=0)
    with pytest.raises(RuntimeError, match="no step_async"):
        envs.step_wait()
    envs.step_async(np.zeros(2, np.int64))
    with pytest.raises(RuntimeError, match="in flight"):
        envs.step_async(np.zeros(2, np.int64))
    with pytest.raises(RuntimeError, match="in flight"):
        envs.reset()
    envs.close()  # drains the step in flight
    offline = dotdict({**_env_cfg(), "algo": {"offline": {"enabled": True}}})
    with pytest.raises(RuntimeError, match="offline"):
        pipelined_vector_env(offline, [])
    with pytest.raises(ValueError, match="env.executor"):
        pipelined_vector_env(dotdict(_env_cfg(executor="threads")), [])
