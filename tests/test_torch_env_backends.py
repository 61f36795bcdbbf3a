"""The port's env backends and video capture held to the JAX package's on
the CPU: the adapters' import gates and the pure logic they share
(``envs/_minecraft.py``), through the cases of
``tests/test_envs/test_adapters.py`` on both packages; ``envs/dmc.py`` step
for step against the JAX ``DMCWrapper`` on a real ``dm_control`` task (where
``dm_control`` is installed);
the Atari target failing as the JAX one fails without ``ale_py``; and
``env.capture_video``: the port warns where the JAX package warns, and with
a recorder (a stand-in for moviepy) records the episodes gymnasium's
``RecordVideo`` records, frame for frame.  All comparisons are exact."""

from __future__ import annotations

import importlib
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

from sheeprl_tpu_torch.utils import imports as gates
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("sheeprl_tpu", "sheeprl_tpu_torch")
ADAPTERS = [("dmc", "_IS_DMC_AVAILABLE"), ("crafter", "_IS_CRAFTER_AVAILABLE"),
            ("diambra", "_IS_DIAMBRA_AVAILABLE"), ("minedojo", "_IS_MINEDOJO_AVAILABLE"),
            ("minerl", "_IS_MINERL_AVAILABLE"), ("minerl_envs.specs", "_IS_MINERL_AVAILABLE"),
            ("super_mario_bros", "_IS_SUPER_MARIO_AVAILABLE")]


def _minecraft(package: str):
    return importlib.import_module(f"{package}.envs._minecraft")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,flag", ADAPTERS)
def test_adapter_import_gate(package, module, flag):
    """An adapter raises ``ModuleNotFoundError`` where its simulator is
    missing and imports where it is present, in both packages."""
    jax_gates = importlib.import_module("sheeprl_tpu.utils.imports")
    assert getattr(gates, flag) == getattr(jax_gates, flag)
    if getattr(gates, flag):
        importlib.import_module(f"{package}.envs.{module}")
    else:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"{package}.envs.{module}")


# ---------------------------------------------------------------------------
# the Minecraft adapters' shared state machines (test_adapters.py's cases)
# ---------------------------------------------------------------------------

STICKY = {  # (attack_for, jump_for), [(attack, jump) selected -> effective]
    "attack_repeats_for_n_steps": ((3, 0), [((1, 0), (1, 0)), ((0, 0), (1, 0)), ((0, 0), (1, 0)), ((0, 0), (0, 0))]),
    "sticky_attack_suppresses_jump": ((2, 0), [((1, 0), (1, 0)), ((0, 1), (1, 0))]),
    "jump_repeats_and_coexists": ((0, 2), [((0, 1), (0, 1)), ((0, 0), (0, 1)), ((0, 0), (0, 0))]),
    "disabled": ((0, 0), [((1, 1), (1, 1)), ((0, 0), (0, 0))]),
}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", sorted(STICKY))
def test_sticky_actions(package, case):
    (attack_for, jump_for), steps = STICKY[case]
    sticky = _minecraft(package).StickyActions(attack_for=attack_for, jump_for=jump_for)
    for (attack, jump), want in steps:
        assert sticky.update(attack=bool(attack), jump=bool(jump)) == tuple(bool(w) for w in want)


@pytest.mark.parametrize("package", PACKAGES)
def test_sticky_actions_reset(package):
    sticky = _minecraft(package).StickyActions(attack_for=5, jump_for=5)
    sticky.update(attack=True, jump=True)
    sticky.reset()
    assert sticky.update(attack=False, jump=False) == (False, False)


def _vec(forward=0, lateral=0, jsn=0, fn=0):
    v = np.zeros(8, dtype=np.int64)
    v[0], v[1], v[2], v[5] = forward, lateral, jsn, fn
    return v


# (attack_for, jump_for), [(vector selected, {slot: effective value})]
MINEDOJO_STICKY = {
    "attack_repeats_on_noop_and_arms_n_minus_1": ((3, 0), [(dict(fn=3), {5: 3}), ({}, {5: 3}), ({}, {5: 3}),
                                                           ({}, {5: 0})]),
    "other_functional_cancels_attack": ((10, 0), [(dict(fn=3), {}), (dict(fn=1), {5: 1}), ({}, {5: 0})]),
    "sticky_attack_does_not_suppress_jump": ((10, 0), [(dict(fn=3), {}), (dict(jsn=1), {2: 1, 5: 3})]),
    "sticky_jump_presses_forward_when_still": ((0, 3), [(dict(jsn=1), {}), ({}, {2: 1, 0: 1})]),
    "forward_selection_blocks_jump_repeat": ((0, 5), [(dict(jsn=1), {}), (dict(forward=1), {2: 0}), ({}, {2: 0})]),
    "stationary_sneak_is_overridden": ((0, 5), [(dict(jsn=1), {}), (dict(jsn=2), {2: 1, 0: 1})]),
    "moving_sneak_cancels": ((0, 5), [(dict(jsn=1), {}), (dict(forward=1, jsn=2), {2: 2}), ({}, {2: 0})]),
}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", sorted(MINEDOJO_STICKY))
def test_minedojo_sticky(package, case):
    (attack_for, jump_for), steps = MINEDOJO_STICKY[case]
    sticky = _minecraft(package).MineDojoSticky(attack_for=attack_for, jump_for=jump_for)
    for selected, want in steps:
        out = sticky.apply(_vec(**selected))
        assert {slot: int(out[slot]) for slot in want} == want


@pytest.mark.parametrize("package", PACKAGES)
def test_pitch_tracker(package):
    tracker = _minecraft(package).PitchTracker
    pt = tracker(limits=(-60, 60))
    assert pt.apply(15.0, -15.0) == (15.0, -15.0) and (pt.pitch, pt.yaw) == (15.0, -15.0)
    pt = tracker(limits=(-60, 60))
    pt.apply(60.0, 0.0)
    assert pt.apply(15.0, 15.0) == (0.0, 15.0) and (pt.pitch, pt.yaw) == (60.0, 15.0)  # pitch vetoed
    pt = tracker()
    pt.apply(0.0, 170.0)
    pt.apply(0.0, 20.0)
    assert pt.yaw == -170.0  # yaw wraps to signed 180
    pt.apply(30.0, 30.0)
    pt.reset(pitch=-10.0, yaw=5.0)
    assert (pt.pitch, pt.yaw) == (-10.0, 5.0)


NAME_TO_ID = {"air": 0, "dirt": 1, "iron ingot": 2, "iron_ingot": 2}
COUNTS = {
    "counts_quantities": ((["dirt", "dirt"], [3, 2]), [0.0, 5.0, 0.0]),
    "air_counts_once_per_slot": ((["air", "air"], [64, 64]), [2.0, 0.0, 0.0]),
    "spaces_normalized_to_underscores": ((["iron ingot"], [4]), [0.0, 0.0, 4.0]),
    "unknown_items_ignored": ((["unobtainium"], [9]), [0.0, 0.0, 0.0]),
    "empty": (([], []), [0.0, 0.0, 0.0]),
}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", sorted(COUNTS))
def test_count_items(package, case):
    (names, quantities), want = COUNTS[case]
    counts = _minecraft(package).count_items(names, quantities, NAME_TO_ID, 3)
    assert counts.dtype == np.float32 and counts.shape == (3,) and counts.tolist() == want


def test_every_env_config_composes_to_a_target_the_port_has():
    """Every env config composes in both packages to the same values, and
    each ``env.wrapper._target_`` names a port target ``make_env`` builds."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.config import compose, own_targets
    from sheeprl_tpu_torch.envs.env import BACKENDS, _wrapper_target

    known = {"envs.env.get_dummy_env", "gymnasium.make", "gymnasium.wrappers.AtariPreprocessing", *BACKENDS}
    for env in ["atari", "crafter", "diambra", "dmc", "dummy", "gym", "minedojo", "minerl", "minerl_obtain_diamond",
                "minerl_obtain_iron_pickaxe", "super_mario_bros", "mujoco"]:
        cfg, jax_cfg = compose(["exp=dreamer_v3", f"env={env}"]), jax_compose(["exp=dreamer_v3", f"env={env}"])
        assert dict(cfg.env) == dict(own_targets(jax_cfg.env)), env
        assert _wrapper_target(cfg.env.wrapper) in known, env


# ---------------------------------------------------------------------------
# DMC step for step, the Atari target
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not gates._IS_DMC_AVAILABLE, reason="dm_control not installed")
def test_dmc_wrapper_steps_as_the_jax_one():
    """cartpole-swingup's vectors through both adapters from the same seed
    and the same actions: observations, rewards, the terminated/truncated
    split (a 40-step episode reaches the time limit), the infos and the
    spaces, bit for bit.  Pixel rendering needs a GL context of its own
    process (``env.sync_env=False``), so vectors only here."""
    from sheeprl_tpu.envs.dmc import DMCWrapper as JaxDMC
    from sheeprl_tpu_torch.envs.dmc import DMCWrapper

    kwargs = dict(from_pixels=False, from_vectors=True, seed=3, task_kwargs={"time_limit": 0.4})
    ours, theirs = DMCWrapper("cartpole", "swingup", **kwargs), JaxDMC("cartpole", "swingup", **kwargs)
    for name in ("action_space", "state_space"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    assert ours.observation_space["state"].shape == theirs.observation_space["state"].shape
    assert ours.reward_range == theirs.reward_range
    rng = np.random.default_rng(0)
    for episode in range(2):
        got, want = ours.reset(seed=episode), theirs.reset(seed=episode)
        np.testing.assert_array_equal(got[0]["state"], want[0]["state"])
        done, steps = False, 0
        while not done:
            action = rng.uniform(-1, 1, ours.action_space.shape).astype(np.float32)
            got, want = ours.step(action), theirs.step(action)
            np.testing.assert_array_equal(got[0]["state"], want[0]["state"])
            assert got[1:4] == want[1:4]
            assert got[4]["discount"] == want[4]["discount"]
            np.testing.assert_array_equal(got[4]["internal_state"], want[4]["internal_state"])
            done, steps = got[2] or got[3], steps + 1
        assert steps == 40 and got[3] and not got[2]
    ours.close()
    theirs.close()


@pytest.mark.skipif(not gates._IS_DMC_AVAILABLE, reason="dm_control not installed")
def test_make_env_builds_a_dmc_env_through_the_port_wrappers():
    """``env=dmc`` with vectors only through the port's ``make_env``: the
    adapter takes the env's seed, and the episode the port's ``TimeLimit``
    cuts is the JAX ``make_env``'s, observation for observation."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.envs.env import make_env as jax_make_env
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env

    overrides = ["exp=dreamer_v3", "env=dmc", "env.capture_video=False", "env.wrapper.from_pixels=False",
                 "env.wrapper.domain_name=cartpole", "env.wrapper.task_name=balance", "env.max_episode_steps=6",
                 "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]
    ours, theirs = make_env(compose(overrides), 5, 0)(), jax_make_env(jax_compose(overrides), 5, 0)()
    assert ours.unwrapped._env.task.random.get_state()[1][0] == theirs.unwrapped._env.task.random.get_state()[1][0]
    rng = np.random.default_rng(1)
    got, want = ours.reset(seed=5), theirs.reset(seed=5)
    for _ in range(6):
        np.testing.assert_array_equal(got[0]["state"], want[0]["state"])
        action = rng.uniform(-1, 1, (1,)).astype(np.float32)
        got, want = ours.step(action), theirs.step(action)
        assert got[1:4] == want[1:4]
    assert got[3] and "episode" in got[4] and "episode" in want[4]
    ours.close()
    theirs.close()


def test_the_atari_target_fails_as_the_jax_one_without_ale_py():
    """``env=atari`` (``AtariPreprocessing`` over ``gymnasium.make``): with
    no ``ale_py`` both packages raise gymnasium's ``NameNotFound``."""
    import gymnasium

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.envs.env import make_env as jax_make_env
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env

    if gates._IS_ATARI_AVAILABLE:
        pytest.skip("ale_py is installed")
    overrides = ["exp=ppo", "env=atari", "env.capture_video=False"]
    for build in (lambda: make_env(compose(overrides), 0, 0)(), lambda: jax_make_env(jax_compose(overrides), 0, 0)()):
        with pytest.raises(gymnasium.error.NameNotFound, match="PongNoFrameskip"):
            build()


def test_adapter_modules_import_no_torch_in_an_env_worker():
    """What a spawned env worker imports for a backend: the adapter, the
    shared state machines and the gates load no torch and no gymnasium."""
    mods = ["sheeprl_tpu_torch.envs._minecraft", "sheeprl_tpu_torch.utils.imports"]
    if gates._IS_DMC_AVAILABLE:
        mods.append("sheeprl_tpu_torch.envs.dmc")
    code = (f"import sys, importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'sheeprl_tpu', 'gymnasium')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# ---------------------------------------------------------------------------
# video capture
# ---------------------------------------------------------------------------


def _cfg_pair(overrides):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.config import compose

    return compose(overrides), jax_compose(overrides)


VIDEO = ["exp=ppo", "env.capture_video=True", "env.max_episode_steps=9", "algo.cnn_keys.encoder=[]",
         "algo.mlp_keys.encoder=[state]"]


@pytest.mark.parametrize("env", ["dummy", "gym"])
def test_capture_video_warns_where_the_jax_package_warns(env, tmp_path):
    """Without moviepy (neither machine has it) the recorder cannot be
    built: both packages warn with the same cause and go on without video;
    the dummy env renders no image, which both refuse first."""
    from sheeprl_tpu.envs.env import make_env as jax_make_env
    from sheeprl_tpu_torch.envs.env import make_env

    if importlib.util.find_spec("moviepy") is not None:
        pytest.skip("moviepy is installed")
    ours, theirs = _cfg_pair(VIDEO + [f"env={env}"])
    messages = []
    for build, cfg, root in ((make_env, ours, "port"), (jax_make_env, theirs, "jax")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            build(cfg, 0, 0, str(tmp_path / root), "train")().close()
        messages.append([str(w.message) for w in caught if "Video capture disabled" in str(w.message)])
    assert len(messages[0]) == len(messages[1]) == 1
    cause = "Render mode is None" if env == "dummy" else "moviepy is not installed"
    assert cause in messages[0][0] and cause in messages[1][0]
    # the first env of a run only; serving's throwaway env never records
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_env(ours, 0, 0, str(tmp_path / "port"), "train", vector_env_idx=1)().close()
        make_env(ours, 0, 0)().close()


class _Clip:
    """A stand-in for moviepy's ``ImageSequenceClip``: records what would
    be written."""

    written: list = []

    def __init__(self, frames, fps):
        self.frames, self.fps = [np.array(f) for f in frames], fps

    def write_videofile(self, path, logger=None):
        _Clip.written.append((Path(path).relative_to(Path(path).parents[1]).as_posix(), self.fps, self.frames))


@pytest.fixture
def fake_moviepy(monkeypatch):
    names = ["moviepy", "moviepy.video", "moviepy.video.io", "moviepy.video.io.ImageSequenceClip"]
    for name in names:
        module = types.ModuleType(name)
        module.__path__ = []
        monkeypatch.setitem(sys.modules, name, module)
    sys.modules["moviepy.video.io.ImageSequenceClip"].ImageSequenceClip = _Clip
    _Clip.written = []
    return _Clip.written


def test_capture_video_records_the_episodes_gymnasium_records(fake_moviepy, tmp_path):
    """CartPole through each package's ``make_env`` with a recorder: nine
    episodes of at most 9 steps; the port's ``RecordVideo`` writes the
    videos gymnasium's writes (episodes 0, 1 and 8 of the capped cubic
    schedule, to ``<run>/train_videos``), frame for frame."""
    from sheeprl_tpu.envs.env import make_env as jax_make_env
    from sheeprl_tpu_torch.envs.env import make_env

    ours, theirs = _cfg_pair(VIDEO + ["env=gym"])
    runs = {}
    for build, cfg, root in ((make_env, ours, "port"), (jax_make_env, theirs, "jax")):
        env = build(cfg, 0, 0, str(tmp_path / root), "train")()
        rng = np.random.default_rng(0)
        env.reset(seed=0)
        for _ in range(9):
            done = False
            while not done:
                _, _, terminated, truncated, _ = env.step(int(rng.integers(0, 2)))
                done = terminated or truncated
            env.reset()
        env.close()
        runs[root], fake_moviepy[:] = list(fake_moviepy), []
    assert [w[:2] for w in runs["port"]] == [w[:2] for w in runs["jax"]]
    assert [w[0] for w in runs["port"]] == [f"train_videos/rl-video-episode-{i}.mp4" for i in (0, 1, 8)]
    for (_, _, got), (_, _, want) in zip(runs["port"], runs["jax"]):
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
