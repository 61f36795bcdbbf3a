"""The host side of the port's DreamerV3 loop against the JAX package, on
the CPU: the replay buffers draw the same samples from the same seeds, the
step slab and the replay-ratio budgeter agree, the optimizer is optax's
``clip_by_global_norm`` + ``adam``, the vector env autoresets as the JAX
package's does, and the checkpoint callback prunes and restores what it
marks."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependentReplayBuffer
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequentialReplayBuffer
from sheeprl_tpu.data.slab import step_slab as jax_step_slab
from sheeprl_tpu.utils.utils import Ratio as JaxRatio
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.slab import step_slab
from sheeprl_tpu_torch.envs.env import make_env_fns, vectorized_env
from sheeprl_tpu_torch.parallel.runtime import Runtime
from sheeprl_tpu_torch.utils.checkpoint import CheckpointCallback, load_state
from sheeprl_tpu_torch.utils.optim import adam, clip_by_global_norm, global_norm
from sheeprl_tpu_torch.utils.utils import Ratio
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _rows(steps: int, n_envs: int, seed: int):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 255, (steps, n_envs, 3, 4, 4), dtype=np.uint8),
        "rewards": rng.normal(size=(steps, n_envs, 1)).astype(np.float32),
        "truncated": np.zeros((steps, n_envs, 1), np.float32),
    }


@pytest.mark.parametrize("memmap", [False, True])
@pytest.mark.parametrize("wrapped", [False, True])  # fill part of the ring / wrap past its end
def test_env_independent_sequential_buffer_samples_as_the_jax_one(tmp_path, memmap, wrapped):
    size, n_envs = 12, 3
    ours = EnvIndependentReplayBuffer(size, n_envs, memmap, tmp_path / "ours", SequentialReplayBuffer)
    theirs = JaxEnvIndependentReplayBuffer(size, n_envs=n_envs, obs_keys=("obs",), memmap=memmap,
                                           memmap_dir=tmp_path / "jax", buffer_cls=JaxSequentialReplayBuffer)
    for rb in (ours, theirs):
        rb.seed(7)
        for i in range(17 if wrapped else 8):
            rb.add(_rows(1, n_envs, i))
        rb.add(_rows(1, 2, 99), indices=[0, 2])  # an episode-end row for two envs
    for _ in range(3):
        got = ours.sample(5, n_samples=2, sequence_length=4)
        want = theirs.sample(5, n_samples=2, sequence_length=4)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape == (2, 4, 5) + want[k].shape[3:]
            np.testing.assert_array_equal(got[k], want[k])


def test_sequential_buffer_refuses_what_it_cannot_sample():
    rb = SequentialReplayBuffer(8)
    with pytest.raises(ValueError):
        rb.sample(2, sequence_length=2)
    rb.add(_rows(3, 1, 0))
    with pytest.raises(ValueError):
        rb.sample(2, sequence_length=4)
    with pytest.raises(KeyError):
        rb.add({"other": np.zeros((1, 1, 1), np.float32)})


def test_step_slab_matches_jax():
    arrays = {"rgb": np.ones((3, 2, 4, 4), np.uint8), "terminated": np.array([True, False, True]),
              "rewards": np.array([0.5, 1.0, -1.0])}
    dtypes = {"terminated": np.float32, "rewards": np.float32}
    got, want = step_slab(3, arrays, dtypes), jax_step_slab(3, arrays, dtypes)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        step_slab(4, arrays)


@pytest.mark.parametrize("ratio,pretrain", [(1.0, 0), (0.5, 0), (0.25, 16), (2.0, 4)])
def test_ratio_pays_what_the_jax_one_pays(ratio, pretrain):
    ours, theirs = Ratio(ratio, pretrain), JaxRatio(ratio, pretrain)
    steps = [4, 8, 12, 13, 20, 21, 22, 40]
    assert [ours(s) for s in steps] == [theirs(s) for s in steps]
    assert ours.state_dict() == theirs.state_dict()


def test_clip_and_adam_are_optax_clip_by_global_norm_and_adam():
    rng = np.random.default_rng(3)
    params = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    torch_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = adam(learning_rate=1e-2, eps=1e-5)(torch_params)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2, eps=1e-5))
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for step in range(4):
        # the first two gradients exceed the clip, the last two do not
        scale = 10.0 if step < 2 else 0.01
        grads = [scale * rng.normal(size=p.shape).astype(np.float32) for p in params]
        tg = [torch.from_numpy(g) for g in grads]
        np.testing.assert_allclose(global_norm(tg).item(), float(optax.global_norm(grads)), rtol=1e-6)
        for p, g in zip(torch_params, clip_by_global_norm(tg, 1.0)):
            p.grad = g
        opt.step()
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, j in zip(torch_params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)


def _cfg(env_id: str, num_envs: int = 3):
    return compose(["exp=dreamer_v3", "env=dummy", f"env.id={env_id}", f"env.num_envs={num_envs}",
                    "env.capture_video=False", "env.screen_size=16", "algo.mlp_keys.encoder=[state]",
                    "run_name=fixed"])


def test_vector_env_autoresets_in_the_same_step_and_reports_episodes():
    envs = vectorized_env(make_env_fns(_cfg("discrete_dummy")))
    obs, _ = envs.reset(seed=1)
    assert obs["rgb"].shape == (3, 3, 16, 16) and obs["state"].shape == (3, 10)
    assert envs.batched_action_shape == (3,)
    ends = []
    for step in range(1, 12):
        obs, rewards, terminated, truncated, infos = envs.step(envs.sample_actions(np.random.default_rng(step)))
        # gymnasium's SyncVectorEnv layout, as the JAX package's: float64
        # rewards, the ended episodes' statistics in final_info
        assert rewards.dtype == np.float64 and terminated.shape == truncated.shape == (3,)
        if terminated.any():
            ends.append(step)
            # the dummy env's last observation rides in final_obs, the reset
            # one comes back
            assert all(f is not None for f in infos["final_obs"])
            assert infos["final_obs"][0]["state"][0] == 5.0 and obs["state"][0, 0] == 0.0
            episode = infos["final_info"]["episode"]
            assert episode["l"][infos["final_info"]["_episode"]].tolist() == [5, 5, 5]
    envs.close()
    assert ends == [5, 10]  # the discrete dummy env ends every fifth step


def test_vector_env_steps_as_the_jax_packages_sync_vector_env():
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.envs.env import make_env_fns as jax_make_env_fns
    from sheeprl_tpu.envs.env import vectorized_env as jax_vectorized_env

    overrides = ["exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.capture_video=False",
                 "env.screen_size=16", "algo.mlp_keys.encoder=[state]", "run_name=fixed"]
    ours = vectorized_env(make_env_fns(compose(overrides)))
    theirs = jax_vectorized_env(jax_make_env_fns(jax_compose(overrides), restartable=False), sync=True)
    for o, t in zip(ours.reset(seed=3)[0].values(), (theirs.reset(seed=3)[0][k] for k in ("rgb", "state"))):
        np.testing.assert_array_equal(o, t)
    for step in range(12):
        actions = np.array([step % 2, 1 - step % 2])
        got, want = ours.step(actions), theirs.step(actions)
        for k in ("rgb", "state"):
            np.testing.assert_array_equal(got[0][k], want[0][k])
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_array_equal(g, w)
        final = want[4].get("final_obs", [None, None])
        for g, w in zip(got[4].get("final_obs", [None, None]), final):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g["state"], w["state"])
    ours.close()
    theirs.close()


@pytest.mark.parametrize("env_id,shape", [("multidiscrete_dummy", (4, 2)), ("continuous_dummy", (4, 2))])
def test_vector_env_samples_random_actions_in_its_space(env_id, shape):
    envs = vectorized_env(make_env_fns(_cfg(env_id, 4)))
    actions = envs.sample_actions(np.random.default_rng(0))
    assert actions.shape == shape == envs.batched_action_shape
    if env_id == "multidiscrete_dummy":
        assert set(np.unique(actions)) <= {0, 1}
    else:
        assert np.isfinite(actions).all() and actions.dtype == np.float32
    envs.close()


def test_checkpoint_callback_marks_truncation_restores_it_and_keeps_the_last(tmp_path):
    rb = EnvIndependentReplayBuffer(8, n_envs=2)
    rb.add(_rows(3, 2, 0))
    runtime = Runtime(accelerator="cpu", callbacks=[CheckpointCallback(keep_last=2)])
    for step in (10, 20, 30):
        runtime.call("on_checkpoint_coupled", ckpt_path=str(tmp_path / f"ckpt_{step}_0.ckpt"), state={"step": step},
                     replay_buffer=rb)
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == ["ckpt_20_0.ckpt", "ckpt_30_0.ckpt"]
    saved = load_state(str(tmp_path / "ckpt_30_0.ckpt"))
    assert saved["step"] == 30
    for sub in saved["rb"]["buffers"]:
        assert sub["buffer"]["truncated"][2, 0, 0] == 1.0  # the last stored step, marked
    for b in rb.buffer:
        assert b.buffer["truncated"][2, 0, 0] == 0.0  # and unmarked in the live buffer
    # buffer.export is ported (tests/test_torch_offline_export.py)
    assert CheckpointCallback(export=True).export and not CheckpointCallback().export


def test_runtime_seeds_a_generator_and_refuses_what_it_does_not_port():
    runtime = Runtime(accelerator="cpu")
    a = torch.rand(3, generator=runtime.seed_everything(4))
    b = torch.rand(3, generator=runtime.seed_everything(4))
    assert torch.equal(a, b) and runtime.world_size == 1 and runtime.is_global_zero
    with pytest.warns(UserWarning, match="trains in float32"):  # 64-true: as the JAX package trains it
        assert Runtime(accelerator="cpu", precision="64-true").compute_dtype == torch.float32
    # the data axis and FSDP are ported (tests/test_torch_parallel.py,
    # tests/test_torch_fsdp*.py): two shards on a (data, model) = (1, 2)
    # layout; more than one node without torchrun's variables is one process
    with pytest.warns(UserWarning, match="more than one shard"):
        assert Runtime(accelerator="cpu", devices=2).world_size == 2
    with pytest.warns(UserWarning, match="more than one shard"):
        two_axis = Runtime(accelerator="cpu", devices=2, fsdp=2, fsdp_min_shard_bytes=256)
    assert (two_axis.world_size, two_axis.fsdp, two_axis.fsdp_min_shard_bytes) == (2, 2, 256)
    with pytest.warns(UserWarning, match="num_nodes=2"):
        assert Runtime(accelerator="cpu", num_nodes=2).world_size == 1
