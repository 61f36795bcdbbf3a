"""The offline loop and the env-sharded device ring over two shards, held to
the JAX package on two of the suite's virtual CPU devices.

- Offline SAC and DroQ with the conservative Q penalty: two train calls of
  two gradient steps over two shards (a replica each, ``run_shards``)
  against the JAX step ``shard_map``-ed over two devices on the same global
  batch; SAC's draws are the same on every shard (its step folds no key),
  DroQ's each shard's own (``fold_in(key, axis_index)``, then the penalty's
  split).  Tolerances: the one-device offline tests' (metrics 1e-5
  relative, parameters 1e-5, Adam's moments 1e-4 of each tree's scale).
- Offline DreamerV3: the JAX offline loop at two devices is stopped after
  its first gradient step, and the port's two shards take that step from the
  same weights, optimizer state, Moments and dataset batch, with each
  shard's draws from the folded key: the metrics (1e-4), the parameters
  (2e-6) and the Moments (1e-5); the port's own offline loop at two shards
  trains on the JAX loop's first batch, its replicas equal and its
  checkpoints (shard 0's state, the global batch size) verified by the JAX
  package.
- The env-sharded ring: over two shards it draws the JAX ring's windows
  (``env_idx`` and ``starts``) from the same seed, each shard's block of a
  batch only from its own envs and gathered from its own storage, its
  state the JAX ring's; it refuses an env count or a batch the shards do
  not divide with the JAX ring's messages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_droq as td
import test_torch_dv3_train as dv3
import test_torch_offline as to
import test_torch_sac as ts
from sheeprl_tpu.data import datasets as jax_datasets
from sheeprl_tpu.data.device_buffer import DeviceSequentialReplayBuffer as JaxDeviceSequentialReplayBuffer
from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.data import datasets
from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer
from sheeprl_tpu_torch.parallel.dp import replicas_equal, run_shards, split
from sheeprl_tpu_torch.parallel.mesh import replicate
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_parallel_dv2_family import SHARDS, _jit_once, _mesh
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

CPU = [torch.device("cpu")] * SHARDS


# ---------------------------------------------------------------------------
# offline SAC and DroQ: the train calls


def _sac_calls():
    from sheeprl_tpu.algos.sac.sac import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.sac.sac import make_train_step

    setup = ts.Setup(ts.TINY + to.CQL)
    steps = ts.Steps(setup, to.CQL)  # the JAX params and states; the port's trees and optimizer checks
    jax_step = jax_make_train_step(setup.actor_def, setup.critic_def, steps.jax_opts, steps.jax_cfg, _mesh(),
                                   setup.target_entropy)
    replicas = replicate(steps.agent, CPU)
    optimizers = [steps.optimizers] + [setup.optimizers(r) for r in replicas[1:]]
    shard_steps = [make_train_step(r, o, steps.cfg, -2.0) for r, o in zip(replicas, optimizers)]
    assert shard_steps[0].cql_samples == to.N_CQL
    for call in range(2):
        data = ts.batch(10 + call, b=SHARDS * ts.B)
        keys = jax.random.split(jax.random.PRNGKey(20 + call), ts.G)
        out = jax_step(steps.params, steps.opt_states, jax.tree_util.tree_map(jnp.asarray, data), keys)
        steps.params, steps.opt_states = out[0], out[1]
        # the step folds no key: every shard draws the same, at its own rows
        eps, uniform, pol = [], [], []
        for key in keys:
            main, k_cql = jax.random.split(key)
            eps.append(np.asarray(jax.random.normal(main, (ts.B, 2))))
            u, e = to.cql_draws(k_cql)
            uniform.append(u)
            pol.append(e)
        cql = {"uniform": torch.from_numpy(np.stack(uniform)), "eps": torch.from_numpy(np.stack(pol))}
        metrics = run_shards([step.body(ts.torch_tree(block), torch.from_numpy(np.stack(eps)), cql)
                              for step, block in zip(shard_steps, split(data, SHARDS, 1))])[0]
        assert replicas_equal([[r, *o.values()] for r, o in zip(replicas, optimizers)])
        np.testing.assert_allclose(metrics.numpy()[:5], np.asarray(out[2]), rtol=1e-5, atol=1e-6)
        steps.check_trees()
        steps.check_optimizers()


def _droq_calls():
    from sheeprl_tpu.algos.droq.droq import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.droq.agent import build_agent
    from sheeprl_tpu_torch.algos.droq.droq import make_train_step
    from sheeprl_tpu_torch.interop.flax_params import dump_trees, optax_state, sac_spec

    setup = td.Setup(td.TINY + to.CQL)
    jax_opts = setup.jax_optimizers()
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {"actor": jax_opts["actor"].init(params["actor"]), "critic": jax_opts["critic"].init(params["critic"]),
                  "alpha": jax_opts["alpha"].init(params["log_alpha"])}
    jax_step = jax_make_train_step(setup.actor_def, setup.critic_def, jax_opts, setup.jax_cfg, -2.0, mesh=_mesh())
    agent = build_agent(setup.cfg, ts.OBS_SPACE, ts.ACT_SPACE, setup.params, "cpu")[0]
    replicas = replicate(agent, CPU)
    optimizers = [setup.optimizers(r) for r in replicas]
    shard_steps = [make_train_step(r, o, setup.cfg, -2.0) for r, o in zip(replicas, optimizers)]
    for call in range(2):
        seed = 30 + 10 * call
        data = ts.batch(seed, b=SHARDS * td.B)
        actor_data = {"observations": ts.batch(seed + 1, b=SHARDS * td.B)["observations"]}
        keys = jax.random.split(jax.random.PRNGKey(seed + 2), td.G)
        params, opt_states, jax_metrics = jax_step(params, opt_states, jax.tree_util.tree_map(jnp.asarray, data),
                                                   jax.tree_util.tree_map(jnp.asarray, actor_data), keys)
        bodies = []
        for d, (step, block, actor_block) in enumerate(zip(shard_steps, split(data, SHARDS, 1),
                                                           split(actor_data, SHARDS, 1))):
            # each shard's key folded, then the penalty's split off first
            halves = [jax.random.split(jax.random.fold_in(k, d)) for k in keys]
            noise = td._noise(setup, [h[0] for h in halves])
            draws = [to.cql_draws(h[1], b=td.B) for h in halves]
            noise["cql_uniform"] = torch.from_numpy(np.stack([u for u, _ in draws]))
            noise["cql_eps"] = torch.from_numpy(np.stack([e for _, e in draws]))
            bodies.append(step.body(ts.torch_tree(block), ts.torch_tree(actor_block), noise))
        metrics = run_shards(bodies)[0].numpy()
        assert replicas_equal([[r, *o.values()] for r, o in zip(replicas, optimizers)])
        np.testing.assert_allclose(metrics[:3], np.asarray(jax_metrics), rtol=1e-5, atol=1e-6)
        got = ts.leaves(dump_trees(sac_spec(replicas[0])))
        for path, value in ts.leaves(params).items():
            np.testing.assert_allclose(got[path], np.asarray(value), atol=1e-5, rtol=1e-5, err_msg=path)
        spec = sac_spec(replicas[0])
        specs = {"actor": spec["actor"], "critic": spec["critic"], "alpha": spec["log_alpha"]}
        for name, opt in optimizers[0].items():
            ts.check_moments(optax_state(opt, specs[name], clip=False)[0], opt_states[name])


@pytest.mark.parametrize("algo", ["sac", "droq"])
def test_two_shard_offline_calls_with_the_penalty_match_the_jax_step_on_two_devices(algo):
    assert len(jax.devices()) >= SHARDS
    {"sac": _sac_calls, "droq": _droq_calls}[algo]()


# ---------------------------------------------------------------------------
# offline DreamerV3: the JAX loop's first step, and the port's loop

DV3 = to.DV3_TINY + ["algo.offline.enabled=true", "algo.total_steps=4", "algo.offline.grad_steps_per_iter=2",
                     "checkpoint.every=2", "algo.run_test=False", "fabric.accelerator=cpu", "fabric.devices=2"]


@pytest.fixture(scope="module")
def dv3_data(tmp_path_factory):
    return to._dataset(tmp_path_factory.mktemp("offline_dv3") / "dv3", "dv3")


class _Stop(Exception):
    pass


def test_offline_dreamer_v3_over_two_shards_takes_the_jax_loops_first_step(dv3_data, tmp_path, monkeypatch):
    from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_dreamer_agent, load_learner_state
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from types import SimpleNamespace

    monkeypatch.chdir(tmp_path)
    overrides = DV3 + [f"algo.offline.dataset_dir={dv3_data}"]
    ours, theirs, first = [], [], {}
    to._recording(monkeypatch, datasets.OfflineDataset, ours)
    to._recording(monkeypatch, jax_datasets.OfflineDataset, theirs)
    out = cli.run(overrides + ["root_dir=port"])
    assert out["shards"] == 2 and out["replicas_equal"] and out["gradient_steps"] == 4
    assert np.isfinite(out["metric_rows"]).all() and len(out["checkpoints"]) == 2
    for ckpt in out["checkpoints"]:
        state = load_state(ckpt)
        assert jax_verify_checkpoint(ckpt) == (True, "verified") and state["batch_size"] == 2 * 2

    make = jax_dv3.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def first_step(params, opt_states, moments, batch, key, tau):
            first.update(jax.tree_util.tree_map(np.asarray, {"params": params, "opt_states": opt_states,
                                                             "moments": moments, "batch": batch}))
            first.update(key=key, tau=float(tau))
            first["out"] = jax.tree_util.tree_map(np.asarray, step(params, opt_states, moments, batch, key, tau))
            raise _Stop

        return first_step

    monkeypatch.setattr(jax_dv3, "make_train_step", recording)
    with pytest.raises(_Stop):
        jax_run(overrides + ["root_dir=jax"])
    assert sorted(ours[0]) == sorted(theirs[0])  # the same global batch of 2 x 2 sequences
    for k in theirs[0]:
        np.testing.assert_array_equal(ours[0][k], theirs[0][k], err_msg=k)

    # the port's two shards take the JAX loop's first step
    cfg = compose(overrides)
    obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8)})
    agent = build_dreamer_agent((2,), False, cfg, obs_space, first["params"], "cpu")
    replicas = replicate(agent, CPU)
    optimizers = [make_optimizers(cfg, r) for r in replicas]
    states = [load_learner_state({"opt_states": first["opt_states"], "moments": first["moments"]}, r, o, "cpu")
              for r, o in zip(replicas, optimizers)]
    steps = [make_train_step(r, o, cfg, False) for r, o in zip(replicas, optimizers)]
    blocks = [{k: dv3._t(np.ascontiguousarray(v, np.float32)) for k, v in b.items()}
              for b in split(first["batch"], SHARDS, 1)]
    monkeypatch.setattr(jax, "jit", _jit_once(jax.jit))
    fake = SimpleNamespace(is_continuous=False, actions_dim=(2,))
    dv3._record_margins(monkeypatch)
    outs = run_shards([step.body(state, block, first["tau"], None,
                                 dv3._jax_noise(fake, jax.random.fold_in(first["key"], d)))
                       for d, (step, state, block) in enumerate(zip(steps, states, blocks))])
    (moments, metrics), (_, other) = outs
    assert torch.equal(metrics, other)
    assert replicas_equal([[*r, *o.values()] for r, o in zip(replicas, optimizers)])
    params, _, jax_moments, jax_metrics = first["out"][:4]
    np.testing.assert_allclose(metrics.numpy()[:len(jax_metrics)], jax_metrics, atol=1e-4, rtol=1e-4)
    want, got = dv3._leaves({k: params[k] for k in ("world_model", "actor", "critic", "target_critic")}), \
        dv3._leaves(agent.trees())
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    for k in ("low", "high"):
        np.testing.assert_allclose(moments[k].numpy(), jax_moments[k], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the env-sharded ring

SIZE, ENVS = 7, 4


def _step(rng, n: int):
    return {"state": rng.normal(size=(1, n, 3)).astype(np.float32),
            "actions": rng.normal(size=(1, n, 2)).astype(np.float32),
            "terminated": (rng.random((1, n, 1)) < 0.2).astype(np.float32),
            "is_first": np.zeros((1, n, 1), np.float32)}


def _rings(seed: int = 0):
    """The port's ring over two shards and the JAX ring over a two-device
    mesh, fed the same steps: whole-env steps and episode-end rows to some
    envs, so the write heads advance apart."""
    ours = DeviceSequentialReplayBuffer(SIZE, ENVS, devices=CPU)
    theirs = JaxDeviceSequentialReplayBuffer(SIZE, ENVS, mesh=_mesh())
    ours.seed(seed)
    theirs.seed(seed)
    rng = np.random.default_rng(seed + 100)
    for i in range(11):
        step = _step(rng, ENVS)
        ours.add({k: torch.from_numpy(v) if k == "actions" else v for k, v in step.items()})
        theirs.add(step)
        if i % 3 == 1:
            idx = [0, 3] if i % 2 else [1]
            extra = _step(rng, len(idx))
            ours.add(extra, idx)
            theirs.add(extra, idx)
    return ours, theirs


def test_the_env_sharded_ring_draws_the_jax_rings_windows_each_shard_from_its_own_envs():
    ours, theirs = _rings()
    want, got = theirs.state_dict(), ours.state_dict()
    for k in want["buffer"]:
        np.testing.assert_array_equal(got["buffer"][k], np.asarray(want["buffer"][k]), err_msg=k)
    for k in ("pos", "filled", "added"):
        np.testing.assert_array_equal(got[k], want[k])
    for seq_len, batch in ((1, 4), (3, 6), (SIZE, 2)):
        (starts, env_idx), (jax_starts, jax_env_idx) = ours._draw(batch, seq_len), theirs._draw(batch, seq_len)
        np.testing.assert_array_equal(env_idx, jax_env_idx)
        np.testing.assert_array_equal(starts, jax_starts)
        b = batch // SHARDS
        for d in range(SHARDS):  # each shard's block from its own envs only
            assert ((env_idx[d * b:(d + 1) * b] // (ENVS // SHARDS)) == d).all()
        got = ours.sample(batch, sequence_length=seq_len, n_samples=2)
        want = theirs.sample(batch, sequence_length=seq_len, n_samples=2)
        for blocks, w in zip(got, want):
            assert isinstance(blocks, list) and len(blocks) == SHARDS
            for k in w:
                assert all(tuple(block[k].shape[:2]) == (seq_len, b) for block in blocks)
                np.testing.assert_array_equal(torch.cat([block[k] for block in blocks], 1).numpy(), np.asarray(w[k]),
                                              err_msg=f"{k} T={seq_len}")
    # one shard's ring restores the two shards' state and draws as the JAX ring
    one, jax_one = DeviceSequentialReplayBuffer(SIZE, ENVS), JaxDeviceSequentialReplayBuffer(SIZE, ENVS)
    one.load_state_dict(ours.state_dict())
    jax_one.load_state_dict(theirs.state_dict())
    one.seed(3)
    jax_one.seed(3)
    np.testing.assert_array_equal(one.sample(4, 3)[0]["state"].numpy(), np.asarray(jax_one.sample(4, 3)[0]["state"]))


def test_the_env_sharded_ring_refuses_what_the_shards_do_not_divide_with_the_jax_messages():
    with pytest.raises(ValueError, match="n_envs \\(3\\) must be divisible by the mesh size \\(2\\) for the "
                                         "env-sharded device buffer"):
        JaxDeviceSequentialReplayBuffer(SIZE, 3, mesh=_mesh())
    with pytest.raises(ValueError, match="n_envs \\(3\\) must be divisible by the mesh size \\(2\\) for the "
                                         "env-sharded device buffer"):
        DeviceSequentialReplayBuffer(SIZE, 3, devices=CPU)
    ours, theirs = _rings()
    for ring in (ours, theirs):
        with pytest.raises(ValueError, match="batch_size \\(3\\) must be divisible by the mesh size \\(2\\)"):
            ring.sample(3, sequence_length=2)
