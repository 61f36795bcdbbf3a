"""The port's PPO held to the JAX package's on the CPU at a test width
(NatureCNN on a 36x36 ``rgb`` key plus an MLP on ``state``): the agent on
converted params in every action family, ``gae``, one full update (2
epochs x 2 minibatches from the JAX permutations, clipped value loss,
advantage normalization, gradient clipping, an annealed learning rate) with
its health stats, the checkpoints both ways, and the serving handle.

Tolerances: forward outputs 1e-5 (fp32, the same products in another
order); sampled discrete actions equal wherever the Gumbel draw's top-2
margin exceeds 1e-4; after the update, parameters 1e-5 and Adam's moments
1e-4 of each tree's scale (Adam divides by a root of a small second moment,
which magnifies the order differences of the gradients), losses 1e-5."""

from __future__ import annotations

import copy

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.ops.numerics import gae as jax_gae
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import linear_schedule, make_train_step
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_params import optax_state, ppo_spec, ppo_to_flax
from sheeprl_tpu_torch.ops.numerics import gae
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

SCREEN = 36
TINY = ["exp=ppo", "env=dummy", "env.capture_video=False", f"env.screen_size={SCREEN}", "algo.dense_units=8",
        "algo.mlp_layers=2", "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=6",
        "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "algo.layer_norm=True",
        "algo.update_epochs=2", "algo.per_rank_batch_size=4", "algo.clip_vloss=True",
        "algo.normalize_advantages=True", "algo.anneal_lr=True", "algo.max_grad_norm=0.5", "algo.ent_coef=0.01",
        "algo.vf_coef=0.5", "diagnostics.health.per_module=True", "seed=3"]
FAMILIES = {
    "discrete": ((3,), False, "auto"),
    "multidiscrete": ((3, 2), False, "auto"),
    "normal": ((2,), True, "normal"),
    "tanh_normal": ((2,), True, "tanh_normal"),
}
# the multi-discrete dummy env's actions (the runs below)
FAMILIES_OF_RUNS = {"multidiscrete_dummy": ((2, 2), False, "auto")}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


class _Setup:
    """One family's JAX agent (params jitted, then perturbed so that every
    leaf moves) and the port's agent on the converted params."""

    def __init__(self, family: str, extra=()):
        actions_dim, continuous, dist = {**FAMILIES, **FAMILIES_OF_RUNS}[family]
        overrides = TINY + [f"distribution.type={dist}", *extra]
        self.cfg, self.jax_cfg = compose(overrides), jax_compose(overrides)
        self.actions_dim, self.continuous = actions_dim, continuous
        self.gym_obs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, SCREEN, SCREEN), np.uint8),
                                        "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
        self.obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, SCREEN, SCREEN), np.uint8),
                                      "state": spaces.Box(-20, 20, (10,), np.float32)})
        holder = []

        def init():
            agent, params, _ = jax_build_agent(None, actions_dim, continuous, self.jax_cfg, self.gym_obs)
            holder.append(agent)
            return params

        params = jax.tree_util.tree_map(np.asarray, jax.jit(init)())
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params)
        self.jax_agent = holder[0]
        self.agent = build_agent(actions_dim, continuous, self.cfg, self.obs_space, self.params, "cpu")
        self.apply = jax.jit(self.jax_agent.apply, static_argnames=("greedy",))

    def obs(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        return {"rgb": rng.integers(0, 256, (n, 3, SCREEN, SCREEN), dtype=np.uint8),
                "state": rng.normal(size=(n, 10)).astype(np.float32)}

    def noise(self, key, n: int):
        """The port's noise for the JAX agent's draws from ``key``."""
        if self.continuous:
            return torch.from_numpy(np.array(jax.random.normal(key, (n, sum(self.actions_dim)))))
        return [torch.from_numpy(np.array(jax.random.gumbel(jax.random.fold_in(key, i), (n, d))))
                for i, d in enumerate(self.actions_dim)]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def setup(request):
    return _Setup(request.param)


def _t(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


def test_agent_matches_the_jax_agent_on_converted_params(setup):
    obs = setup.obs(6, 1)
    key = jax.random.PRNGKey(7)
    want = [np.asarray(x) for x in setup.apply(setup.params, obs, key=key)]
    with torch.no_grad():
        got = [x.numpy() for x in setup.agent(_t(obs), noise=setup.noise(key, 6))]
        greedy = [x.numpy() for x in setup.agent(_t(obs), greedy=True)]
        values = setup.agent.get_values(_t(obs)).numpy()
    want_greedy = [np.asarray(x) for x in setup.apply(setup.params, obs, key=key, greedy=True)]
    if setup.continuous:
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(greedy[0], want_greedy[0], atol=1e-5, rtol=1e-5)
    else:
        # the same Gumbel draw: equal wherever it does not nearly tie
        logits = [np.asarray(x) for x in jax.jit(lambda p, o: setup.jax_agent.apply(
            p, o, method=lambda m, o: [h(m.actor_backbone(m._features(o))) for h in m.actor_heads]))(
            setup.params, obs)]
        for i, (lg, g) in enumerate(zip(logits, setup.noise(key, 6))):
            z = np.sort(lg + g.numpy(), axis=-1)
            clear = z[:, -1] - z[:, -2] > 1e-4
            np.testing.assert_array_equal(got[0][clear, i], want[0][clear, i])
        np.testing.assert_array_equal(greedy[0], want_greedy[0])
    # the port's log-prob and entropy are [N, 1] in every family; the JAX
    # agent's continuous ones [N]
    for g, w in zip(got[1:3] + greedy[1:3], want[1:3] + want_greedy[1:3]):
        np.testing.assert_allclose(g.reshape(-1), w.reshape(-1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[3], want[3], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(values, want[3], atol=1e-5, rtol=1e-5)
    # evaluating given actions (the update's path)
    actions = np.array(want[0])
    w_eval = [np.asarray(x) for x in setup.apply(setup.params, obs, actions=actions)]
    with torch.no_grad():
        g_eval = [x.numpy() for x in setup.agent(_t(obs), actions=torch.from_numpy(actions))]
    for g, w in zip(g_eval[1:], w_eval[1:]):
        np.testing.assert_allclose(g.reshape(-1), w.reshape(-1), atol=1e-5, rtol=1e-5)
    # the converter round-trips, the NatureCNN dense rows permuted back
    for path, value in _leaves(setup.params).items():
        np.testing.assert_array_equal(_leaves(ppo_to_flax(setup.agent))[path], value, err_msg=path)


def test_gae_matches_jax():
    """Dones mid-rollout and at its last step (the JAX ``next_nonterminal``
    of the last step is ``1 - dones[-1]``); 1e-6."""
    rng = np.random.default_rng(2)
    T, N = 7, 3
    rewards = rng.normal(size=(T, N, 1)).astype(np.float32)
    values = rng.normal(size=(T, N, 1)).astype(np.float32)
    dones = (rng.random((T, N, 1)) < 0.3).astype(np.float32)
    dones[-1, 0] = 1.0
    next_value = rng.normal(size=(N, 1)).astype(np.float32)
    want = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones), jnp.asarray(next_value), T, 0.99,
                   0.95)
    got = gae(*(torch.from_numpy(x) for x in (rewards, values, dones, next_value)), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def _jax_optimizer(jax_cfg, total_updates: int):
    schedule = optax.linear_schedule(init_value=jax_cfg.algo.optimizer.learning_rate, end_value=0.0,
                                     transition_steps=total_updates)
    return optax.chain(optax.clip_by_global_norm(jax_cfg.algo.max_grad_norm),
                       jax_instantiate(jax_cfg.algo.optimizer, learning_rate=schedule))


class _Mesh:
    devices = np.zeros(1)


def _data(n: int, s: _Setup, seed: int):
    rng = np.random.default_rng(seed)
    obs = s.obs(n, seed)
    if s.continuous:
        actions = rng.normal(size=(n, sum(s.actions_dim))).astype(np.float32)
        if s.cfg.distribution.type == "tanh_normal":
            actions = np.tanh(actions)
    else:
        actions = np.stack([rng.integers(0, d, n) for d in s.actions_dim], -1).astype(np.float32)
    col = lambda: rng.normal(size=(n, 1)).astype(np.float32)  # noqa: E731
    return {"obs": obs, "actions": actions, "logprobs": col() - 1.0, "values": col(), "returns": col(),
            "advantages": col()}


def _port_update(s: _Setup, params, opt_state_tree, total_updates: int, num_minibatches: int):
    """The port's agent, optimizer and update from flax params and (when
    given) a saved optax state."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.interop.flax_params import optimizer_state_dict

    agent = build_agent(s.actions_dim, s.continuous, s.cfg, s.obs_space, params, "cpu")
    optimizer = instantiate(s.cfg.algo.optimizer)(agent.parameters())
    if opt_state_tree is not None:
        optimizer.load_state_dict(optimizer_state_dict(opt_state_tree, optimizer, ppo_spec(agent)))
    schedule = linear_schedule(s.cfg.algo.optimizer.learning_rate, 0.0, total_updates)
    step = make_train_step(agent, optimizer, s.cfg, num_minibatches, int(s.cfg.algo.per_rank_batch_size), schedule)
    return agent, optimizer, step


def _check_update(s, jax_out, agent, optimizer, metrics, health_names):
    params, opt_state, jax_metrics, jax_health = jax_out
    np.testing.assert_allclose(metrics[:5].numpy(), np.asarray(jax_metrics), atol=1e-5, rtol=1e-5)
    health = dict(zip(health_names, metrics[5:].numpy()))
    assert sorted(health) == sorted(jax_health) and "module/critic/update_ratio" in health
    for k, v in jax_health.items():
        # dead_frac: the same counts, averaged over the minibatches in
        # another order (1e-6)
        tol = 1e-6 if k.endswith("dead_frac") else 1e-4
        np.testing.assert_allclose(health[k], float(v), rtol=tol, atol=tol / 10, err_msg=k)
    got = _leaves(ppo_to_flax(agent))
    for p, value in _leaves(params).items():
        np.testing.assert_allclose(got[p], value, atol=1e-5, rtol=1e-5, err_msg=p)
    ours = optax_state(optimizer, ppo_spec(agent), clip=True, schedule=True)
    adam, sched = opt_state[1]
    assert int(ours[1][0].fields[0]) == int(adam.count) == int(sched.count) == int(ours[1][1].fields[0])
    for slot, tree in ((1, adam.mu), (2, adam.nu)):
        want, mine = _leaves(tree), _leaves(ours[1][0].fields[slot])
        scale = max(float(np.abs(v).max()) for v in want.values())
        for p in want:
            np.testing.assert_allclose(mine[p], want[p], atol=1e-4 * scale, rtol=1e-3, err_msg=p)


@pytest.mark.parametrize("family", ["discrete", "multidiscrete"])
def test_update_matches_the_jax_train_step(family):
    """Two consecutive update phases (2 epochs x 2 minibatches each, the
    JAX keys' permutations), so the second runs on an annealed learning
    rate and a nonzero Adam count: params, Adam's state (optax's layout),
    the five metrics and the health stats (per module, with value_ev)."""
    s = _Setup(family)
    n, mb = 8, 2
    total_updates = 10
    opt = _jax_optimizer(s.jax_cfg, total_updates)
    jax_cfg = copy.deepcopy(s.jax_cfg)
    jax_step = jax_make_train_step(s.jax_agent, opt, jax_cfg, _Mesh(), mb, 4)
    params, opt_state = jax.tree_util.tree_map(jnp.asarray, s.params), opt.init(s.params)
    agent, optimizer, step = _port_update(s, s.params, None, total_updates, mb)
    for it in range(2):
        data = _data(n, s, 10 + it)
        key = jax.random.PRNGKey(20 + it)
        coefs = (0.2 - 0.05 * it, 0.01, 0.5)
        out = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data), key,
                       tuple(jnp.float32(c) for c in coefs))
        params, opt_state = out[0], out[1]
        perms = [torch.from_numpy(np.array(jax.random.permutation(k, n))) for k in jax.random.split(key, 2)]
        torch_data = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                          else torch.from_numpy(v)) for k, v in data.items()}
        metrics = step(torch_data, perms, coefs)
        _check_update(s, jax.tree_util.tree_map(np.asarray, out), agent, optimizer, metrics, step.health_names)


RUN = TINY + ["fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=4", "algo.total_steps=16",
              "metric.logger=null", "metric.log_every=8", "buffer.memmap=False", "checkpoint.every=8",
              "distribution.type=auto", "env.id=multidiscrete_dummy"]
RUN_UPDATES = 2 * 2 * 2  # iterations x epochs x minibatches


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port PPO run on the CPU: 2 iterations, a checkpoint after each."""
    out = cli.run(RUN + [f"root_dir={tmp_path_factory.mktemp('ppo_port')}"])
    assert len(out["checkpoints"]) == 2
    return out


def _restored_steps(ckpt: str):
    """One checkpoint restored as each package's loop restores it (the
    agent, then the optimizer state into ``optimizer.init``'s tree), with
    each package's update."""
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    s = _Setup("multidiscrete_dummy")
    jax_state, state = jax_load_state(ckpt), load_state(ckpt)
    params = jax.tree_util.tree_map(jnp.asarray, jax_state["agent"])
    opt = _jax_optimizer(s.jax_cfg, RUN_UPDATES)
    opt_state = jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=getattr(ref, "dtype", None)),
                                       opt.init(params), jax_state["opt_state"])
    jax_step = jax_make_train_step(s.jax_agent, opt, s.jax_cfg, _Mesh(), 2, 4)
    agent, optimizer, step = _port_update(s, state["agent"], state["opt_state"], RUN_UPDATES, 2)
    return s, (params, opt_state, jax_step), (agent, optimizer, step)


def _one_update_each(restored):
    s, (params, opt_state, jax_step), (agent, optimizer, step) = restored
    data = _data(8, s, 30)
    key = jax.random.PRNGKey(31)
    coefs = (0.2, 0.01, 0.5)
    out = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data), key,
                   tuple(jnp.float32(c) for c in coefs))
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, 8))) for k in jax.random.split(key, 2)]
    torch_data = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                      else torch.from_numpy(v)) for k, v in data.items()}
    metrics = step(torch_data, perms, coefs)
    _check_update(s, jax.tree_util.tree_map(np.asarray, out), agent, optimizer, metrics, step.health_names)


def test_a_port_checkpoint_verifies_and_resumes_in_the_jax_package(port_run):
    """The JAX ``verify_checkpoint`` accepts the port's manifest; the JAX
    loop's restore reads the agent and the optax state (clip, Adam, the
    schedule's count), and its next update matches the port's from the same
    checkpoint."""
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint

    ckpt = port_run["checkpoints"][0]
    assert jax_verify_checkpoint(ckpt) == (True, "verified")
    restored = _restored_steps(ckpt)
    assert int(restored[1][1][1][0].count) == RUN_UPDATES // 2  # one iteration's updates
    _one_update_each(restored)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX package's PPO run writes a checkpoint; the port's ``run``
    resumes from its directory and trains on, and the next update from that
    checkpoint matches in both packages."""
    from sheeprl_tpu.cli import run as jax_run

    monkeypatch.chdir(tmp_path)
    jax_run(RUN + ["root_dir=jax_ppo", "algo.run_test=False"])  # its eager test episode is not read
    ckpts = sorted(tmp_path.rglob("*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [int(p.name.split("_")[1]) for p in ckpts] == [8, 16]
    _one_update_each(_restored_steps(str(ckpts[0])))
    # from the mid-run checkpoint: the run's second iteration, in the port
    out = cli.run(RUN + [f"checkpoint.resume_from={ckpts[0]}", "root_dir=port_resumed"])
    assert out["start_iter"] == 2 and out["iterations"] == 1 and out["policy_steps"] == 16
    assert np.isfinite(out["metric_rows"]).all()


def test_serving_handle_acts_as_the_jax_handle(setup):
    from sheeprl_tpu.serving.loader import _ppo_like_handle
    from sheeprl_tpu_torch.serving.loader import _ppo_handle

    action_space = (gym.spaces.Box(-1, 1, (sum(setup.actions_dim),)) if setup.continuous
                    else gym.spaces.MultiDiscrete(list(setup.actions_dim)))
    port_space = (spaces.Box(-1, 1, (sum(setup.actions_dim),)) if setup.continuous
                  else spaces.MultiDiscrete(list(setup.actions_dim)))
    jax_handle = _ppo_like_handle(setup.jax_cfg, setup.gym_obs, action_space, setup.params)
    handle = _ppo_handle(setup.cfg, setup.obs_space, port_space, setup.params, "cpu")
    assert handle.obs_spec == jax_handle.obs_spec and handle.action_shape == jax_handle.action_shape
    rows = [handle.validate({k: v[i] for k, v in setup.obs(4, 5).items()}) for i in range(3)]
    obs = handle.assemble(rows, 4)
    key = jax.random.PRNGKey(9)
    for greedy in (True, False):
        want = np.asarray(jax.jit(jax_handle.make_step(greedy))(setup.params, obs, key))
        got = handle.make_step(greedy)(handle.params, _t(obs), None, setup.noise(key, 4)).numpy()
        if setup.continuous or greedy:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert got.shape == want.shape and (got == want).mean() >= 0.75  # near ties may flip


@pytest.mark.parametrize("executor", ["sync", "shared_memory"])
def test_run_trains_through_each_executor_and_logs_the_timer_metrics(tmp_path, executor):
    out = cli.run(RUN + [f"env.executor={executor}", f"root_dir={tmp_path}", "checkpoint.every=0"])
    assert out["iterations"] == 2 and np.isfinite(out["metric_rows"]).all()
    for logged in out["logged"]:
        assert logged["Time/sps_env_interaction"] > 0 and logged["Time/sps_train"] > 0
        assert np.isfinite([logged[k] for k in ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")]).all()
    assert out["health_rows"]["value_ev"].shape == (2,)


def test_run_trains_on_a_gymnasium_env(tmp_path):
    """``exp=ppo`` with its own env (``env=gym``, CartPole-v1 through
    gymnasium.make) on the CPU; the timer off, as ``metric.disable_timer``
    asks."""
    out = cli.run(["exp=ppo", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=16",
                   "algo.per_rank_batch_size=16", "algo.update_epochs=1", "algo.total_steps=64", "metric.logger=null",
                   "metric.log_every=32", "metric.disable_timer=True", "checkpoint.every=0", f"root_dir={tmp_path}"])
    assert out["iterations"] == 2 and np.isfinite(out["metric_rows"]).all()
    assert out["logged"] and all("Time/sps_train" not in m for m in out["logged"])
    assert any("Rewards/rew_avg" in m for m in out["logged"]) and out["test_reward"] >= 1.0


# bf16: the losses within a few bf16 steps of the JAX step's (each layer
# rounds its output to 8 significant bits, in orders the two compilers
# choose); the parameters within 4 bf16 steps of each tree's scale
BF16_LOSS_ATOL, BF16_PARAM_STEPS = 2**-6, 4


@pytest.mark.parametrize("precision", ["bf16-mixed", "bf16-true"])
def test_update_matches_the_jax_train_step_in_bf16(precision):
    """One update phase (2 epochs x 2 minibatches) under ``precision`` from
    converted params: the agent and the observations cast to bf16 in the
    loss as the JAX loss casts them, the pixel branch in fp32 on the bf16
    weights as flax promotes a uint8 frame scaled to fp32 (and under
    ``bf16-true`` the weights and Adam's state stored in bf16)."""
    s = _Setup("discrete", [f"fabric.precision={precision}"])
    true = precision == "bf16-true"
    dtype = jnp.bfloat16 if true else jnp.float32
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), s.params)
    opt = _jax_optimizer(s.jax_cfg, 10)
    opt_state = opt.init(params)
    jax_step = jax_make_train_step(s.jax_agent, opt, s.jax_cfg, _Mesh(), 2, 4)
    agent, optimizer, step = _port_update(s, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
                                          None, 10, 2)
    agent.to(torch.bfloat16 if true else torch.float32)
    data = _data(8, s, 40)
    key = jax.random.PRNGKey(41)
    coefs = (0.2, 0.01, 0.5)
    out = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data), key,
                   tuple(jnp.float32(c) for c in coefs))
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, 8))) for k in jax.random.split(key, 2)]
    torch_data = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                      else torch.from_numpy(v)) for k, v in data.items()}
    metrics = step(torch_data, perms, coefs).numpy()
    want = np.asarray(out[2])
    assert np.isfinite(metrics).all() and metrics[4] == want[4] == 0
    np.testing.assert_allclose(metrics[:3], want[:3], rtol=0, atol=BF16_LOSS_ATOL * max(1.0, np.abs(want[:3]).max()))
    assert all(p.dtype == (torch.bfloat16 if true else torch.float32) for p in agent.parameters())
    got = _leaves(ppo_to_flax(agent))
    for path, value in _leaves(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out[0])).items():
        scale = max(float(np.abs(value).max()), 1e-3)
        np.testing.assert_allclose(got[path], value, rtol=0, atol=BF16_PARAM_STEPS * 2**-8 * scale, err_msg=path)


@pytest.mark.parametrize("precision", ["bf16-mixed", "bf16-true"])
def test_run_trains_in_bf16(tmp_path, precision):
    """``run`` under ``precision`` (on ``state``: the pixel branch's bf16 is
    held by the update test above): finite losses, checkpoints in fp32 (the
    JAX package's layout), the test episode played."""
    out = cli.run(RUN + [f"fabric.precision={precision}", f"root_dir={tmp_path}", "algo.cnn_keys.encoder=[]"])
    assert out["iterations"] == 2 and np.isfinite(out["metric_rows"]).all()
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    leaves = _leaves(load_state(out["checkpoints"][-1])["agent"])
    assert all(v.dtype == np.float32 for v in leaves.values())
    assert out["test_reward"] is not None


def test_serve_answers_a_port_checkpoint_over_http_and_refuses_what_it_does_not_run(port_run):
    import json
    import os
    import threading
    import urllib.error
    import urllib.request

    from sheeprl_tpu_torch.data.datasets import OfflineDataset
    from sheeprl_tpu_torch.serving.server import ServeApp

    ckpt = port_run["checkpoints"][-1]
    cfg, path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu",
                                          "serving.batch_buckets=[4]", f"serving.models={{b: {ckpt}}}",
                                          "serving.request_log.enabled=True"])
    app = ServeApp(cfg, path, device)
    assert app.registry.names() == ["b", "default"] and app.request_log is not None
    host, port = app.start()
    url = f"http://{host}:{port}"
    rng = np.random.default_rng(0)
    replies = []

    def post(payload):
        req = urllib.request.Request(url + "/act", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    def client(i):
        obs = {"rgb": rng.integers(0, 256, (3, SCREEN, SCREEN)).tolist(), "state": rng.normal(size=10).tolist()}
        replies.append(post({"obs": obs, "greedy": i % 2 == 0}))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert len(replies) == 6 and all(status == 200 for status, _ in replies)
        for _, body in replies:
            action = np.asarray(body["action"])
            assert action.shape == (2,) and set(action.tolist()) <= {0.0, 1.0, 2.0}
        status, body = post({"obs": {"rgb": np.zeros((3, SCREEN, SCREEN)).tolist(), "state": [0.0] * 10},
                             "session": "s"})
        assert status == 400 and "statelessly" in body["error"]
        obs = {"rgb": np.zeros((3, SCREEN, SCREEN)).tolist(), "state": [0.0] * 10}
        status, via_b = post({"obs": obs, "model": "b"})
        assert status == 200 and via_b["action"] == post({"obs": obs})[1]["action"]
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["algo"] == "ppo" and health["models"]["default"]["stateful"] is False
        assert set(health["models"]) == {"b", "default"}
    finally:
        app.close()
    for model, rows in (("default", 7), ("b", 1)):
        logged = OfflineDataset(os.path.join(app.log_dir, "requests", model))
        assert logged.total_rows == rows and logged.meta["meta"]["algo"] == "ppo"


def test_drills_skip_a_poisoned_update_and_preempt_with_a_verified_checkpoint(tmp_path):
    """``diagnostics.sentinel.policy=skip_update`` with the second
    iteration's batch poisoned (its NaN actions included): every minibatch
    of it is counted non-finite and skipped, so the agent and Adam's state
    end as the first iteration left them, bit for bit; then a preemption at
    the first iteration writes a checkpoint that verifies and exits 75."""
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.resilience.preemption import PreemptedExit
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    out = cli.run(RUN + [f"root_dir={tmp_path / 'skip'}", "diagnostics.sentinel.enabled=True",
                         "diagnostics.sentinel.policy=skip_update", "diagnostics.sentinel.inject_nan_iter=2",
                         "algo.run_test=False"])
    assert out["nonfinite_updates"].tolist() == [0.0, 4.0]
    first, last = (load_state(p) for p in out["checkpoints"])
    # optax's (EmptyState, (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)))
    adam_first, adam_last = first["opt_state"][1][0], last["opt_state"][1][0]
    assert int(np.asarray(adam_first[0])) == int(np.asarray(adam_last[0])) == 4
    for a, b in ((first["agent"], last["agent"]), (adam_first[1], adam_last[1]), (adam_first[2], adam_last[2])):
        a, b = _leaves(a), _leaves(b)
        assert a.keys() == b.keys()
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], err_msg=path)
    with pytest.raises(PreemptedExit) as exc:
        cli.run(RUN + [f"root_dir={tmp_path / 'preempt'}", "diagnostics.resilience.inject_preempt_iter=1",
                       "diagnostics.resilience.async_checkpoint=False", "env.executor=shared_memory"])
    assert exc.value.code == 75
    (ckpt,) = sorted((tmp_path / "preempt").rglob("*.ckpt"))
    assert verify_checkpoint(str(ckpt)) == (True, "verified")
