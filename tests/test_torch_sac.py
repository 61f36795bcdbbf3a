"""The port's SAC held to the JAX package's on the CPU at a test width
(hidden 8, two critics, batch 4 on a 10-dim ``state`` and 2-dim actions in
``[-1, 1]``): the replay buffer's uniform draws; optax's ``adamw`` and its
state; the actor and the stacked critics on converted params; two
consecutive train calls of two gradient steps against the JAX
``make_train_step`` with the JAX step's own normal draws, in fp32 (the
metrics, the health stats, every tree and Adam's moments), under
``skip_update`` with a poisoned batch and in ``bf16-mixed`` / ``bf16-true``;
the loop on ``LunarLanderContinuous-v3``, its checkpoints read and resumed
by the JAX package and a JAX checkpoint resumed and evaluated here; the
``sac`` serving handle and ``serve``; the options ``run`` refuses.

Tolerances: forward outputs 1e-5; after the steps the metrics 1e-5
relative, the parameters 1e-5 and Adam's moments 1e-4 of each tree's scale
(XLA and PyTorch sum the gradients in different orders); bf16 steps a few
bf16 steps (2^-8 relative each) of the losses, stated at the check."""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac.sac import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import make_train_step
from sheeprl_tpu_torch.config import compose, instantiate
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_params import dump_trees, optax_state, optimizer_state_dict, sac_spec
from sheeprl_tpu_torch.utils.checkpoint import load_state
from sheeprl_tpu_torch.utils.optim import adamw
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "algo.hidden_size=8",
        "algo.per_rank_batch_size=4", "algo.mlp_keys.encoder=[state]", "diagnostics.health.per_module=True",
        "seed=3"]
GYM_OBS = gym.spaces.Dict({"state": gym.spaces.Box(-20, 20, (10,), np.float32)})
GYM_ACT = gym.spaces.Box(-1.0, 1.0, (2,), np.float32)
OBS_SPACE = spaces.Dict({"state": spaces.Box(-20, 20, (10,), np.float32)})
ACT_SPACE = spaces.Box(-1.0, 1.0, (2,), np.float32)
G, B = 2, 4


class _Mesh:
    devices = np.zeros(1)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def jit_build(fn):
    """``fn()``'s flax init, jitted (eager inits compile op by op); returns
    the module definitions it closes over and the numpy params."""
    holder = []

    def init():
        out = fn()
        holder.append(out[:-1])
        return out[-1]

    params = jax.tree_util.tree_map(np.asarray, jax.jit(init)())
    return holder[0], params


def perturb(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (a + scale * rng.normal(size=a.shape)).astype(a.dtype), params)


class Setup:
    """The JAX SAC definitions and (perturbed) params at ``overrides``, and
    the port's config; ``agent()`` builds the port's agent on them."""

    def __init__(self, overrides, gym_obs=GYM_OBS):
        self.cfg, self.jax_cfg = compose(overrides), jax_compose(overrides)

        def init():
            actor_def, critic_def, params, target_entropy = jax_build_agent(None, self.jax_cfg, gym_obs, GYM_ACT)
            return actor_def, critic_def, target_entropy, params

        (self.actor_def, self.critic_def, self.target_entropy), params = jit_build(init)
        params = perturb(params)
        params["target_critic"] = perturb(params["critic"], 1)
        params["log_alpha"] = np.asarray([-0.4], np.float32)
        self.params = params

    def agent(self, params=None, device="cpu"):
        agent, target_entropy = build_agent(self.cfg, OBS_SPACE, ACT_SPACE, self.params if params is None else params,
                                            device)
        assert target_entropy == self.target_entropy == -2
        return agent

    def jax_optimizers(self):
        a = self.jax_cfg.algo
        return {"actor": jax_instantiate(a.actor.optimizer), "critic": jax_instantiate(a.critic.optimizer),
                "alpha": jax_instantiate(a.alpha.optimizer)}

    def optimizers(self, agent):
        a = self.cfg.algo
        return {"actor": instantiate(a.actor.optimizer)(agent.actor.parameters()),
                "critic": instantiate(a.critic.optimizer)(agent.critic.parameters()),
                "alpha": instantiate(a.alpha.optimizer)([agent.log_alpha])}


@pytest.fixture(scope="module")
def setup():
    return Setup(TINY)


def batch(seed, g=G, b=B, obs_dim=10, act_dim=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"observations": f(g, b, obs_dim), "next_observations": f(g, b, obs_dim),
            "actions": rng.uniform(-1, 1, (g, b, act_dim)).astype(np.float32), "rewards": f(g, b, 1),
            "terminated": (rng.random((g, b, 1)) < 0.3).astype(np.float32)}


# --- the replay buffer ------------------------------------------------------


def _fill(buf, steps, n_envs, seed=0):
    rng = np.random.default_rng(seed)
    for t in range(steps):
        buf.add({"observations": rng.normal(size=(1, n_envs, 3)).astype(np.float32),
                 "actions": np.full((1, n_envs, 1), t, np.float32),
                 "rewards": rng.normal(size=(1, n_envs, 1)).astype(np.float32)})


@pytest.mark.parametrize("next_obs", [False, True])
@pytest.mark.parametrize("steps", [5, 11])  # part-full and full (wrapped) at size 8
@pytest.mark.parametrize("n_samples", [1, 3])
def test_replay_sample_draws_the_jax_buffers_indices_and_values(next_obs, steps, n_samples):
    ours, theirs = ReplayBuffer(8, 3), JaxReplayBuffer(8, 3)
    for buf in (ours, theirs):
        buf.seed(7)
        _fill(buf, steps, 3)
    for _ in range(2):
        got = ours.sample(batch_size=5, sample_next_obs=next_obs, n_samples=n_samples)
        want = theirs.sample(batch_size=5, sample_next_obs=next_obs, n_samples=n_samples)
        assert sorted(got) == sorted(want) and ("next_observations" in got) == next_obs
        for k in want:
            assert got[k].shape == (n_samples, 5) + want[k].shape[2:]
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if next_obs and steps > 8:
        # the newest row (t = steps - 1) has no successor in a full buffer
        assert (got["actions"] != steps - 1).all()


def test_replay_sample_refuses_what_the_jax_buffer_refuses():
    buf = ReplayBuffer(4, 1)
    with pytest.raises(ValueError, match="No sample"):
        buf.sample(2)
    _fill(buf, 1, 1)
    with pytest.raises(RuntimeError, match="single stored step"):
        buf.sample(2, sample_next_obs=True)


# --- optax's adamw ---------------------------------------------------------


def _optax_names(state):
    return [type(s).__name__ for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, tuple) and hasattr(x, "_fields"))]


def test_adamw_matches_optax_over_several_steps_with_its_state_both_ways(setup):
    """Five steps of random gradients through ``optax.adamw`` and the port's
    on the actor's parameters; the state as ``optax_state`` writes it (the
    classes of ``optax.adamw(...).init``) and as ``optimizer_state_dict``
    reads the JAX one back."""
    kwargs = dict(learning_rate=1e-2, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1)
    tx = optax.adamw(**kwargs)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params["actor"])
    state = tx.init(params)
    assert _optax_names(state) == ["ScaleByAdamState", "EmptyState", "EmptyState"]
    agent = setup.agent()
    spec = sac_spec(agent)["actor"]
    opt = adamw(**kwargs)(agent.actor.parameters())
    rng = np.random.default_rng(2)
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), setup.params["actor"])
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        from sheeprl_tpu_torch.interop.flax_params import _walk

        for tensor, value in _walk(spec, grads, "", {}):
            tensor.grad = torch.from_numpy(value)
        opt.step()
        opt.zero_grad(set_to_none=True)
    got, want = leaves(dump_trees(spec)), leaves(params)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6, rtol=1e-6, err_msg=path)
    ours = optax_state(opt, spec, clip=False)[0]
    assert [type(s).__name__ for s in ours] == _optax_names(state)
    assert int(ours[0].fields[0]) == int(state[0].count) == 5
    for mine, theirs in ((ours[0].fields[1], state[0].mu), (ours[0].fields[2], state[0].nu)):
        mine, theirs = leaves(mine), leaves(theirs)
        assert sorted(mine) == sorted(theirs)
        for p in theirs:
            np.testing.assert_allclose(mine[p], theirs[p], atol=1e-6, rtol=1e-5, err_msg=p)
    other = setup.agent()
    fresh = adamw(**kwargs)(other.actor.parameters())
    fresh.load_state_dict(optimizer_state_dict(jax.tree_util.tree_map(np.asarray, state), fresh,
                                               sac_spec(other)["actor"]))
    for a, b in zip(fresh.state.values(), opt.state.values()):
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6, rtol=1e-5)
        assert float(a["step"]) == float(b["step"]) == 5


def test_adamw_refuses_the_variants_it_does_not_port():
    for bad in (dict(mask=lambda p: p), dict(nesterov=True), dict(eps_root=1e-8), dict(mu_dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            adamw(1e-3, **bad)
    opt = instantiate({"_target_": "optax.adamw", "learning_rate": 1e-3})([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.AdamW) and opt.defaults["weight_decay"] == 1e-4  # optax's default


# --- the modules ------------------------------------------------------------


def test_actor_and_critics_match_the_jax_modules(setup):
    agent = setup.agent()
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(6, 10)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (6, 2)))
    p = setup.params
    mean, std = setup.actor_def.apply(p["actor"], obs)
    t_mean, t_std = agent.actor(torch.from_numpy(obs))
    np.testing.assert_allclose(t_mean.detach().numpy(), mean, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_std.detach().numpy(), std, atol=1e-5, rtol=1e-5)
    action, logp = setup.actor_def.apply(p["actor"], obs, key, method="sample_and_log_prob")
    t_action, t_logp = agent.actor.sample_and_log_prob(torch.from_numpy(obs), torch.from_numpy(np.array(eps)))
    np.testing.assert_allclose(t_action.detach().numpy(), action, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_logp.detach().numpy(), logp, atol=1e-5, rtol=1e-5)
    greedy = setup.actor_def.apply(p["actor"], obs, method="greedy_action")
    np.testing.assert_allclose(agent.actor.greedy_action(torch.from_numpy(obs)).detach().numpy(), greedy, atol=1e-6)
    # near the bounds: large draws saturate the squash, and the log-prob's
    # correction log(scale * (1 - y^2) + 1e-6) dominates
    big = np.asarray(jax.random.normal(key, (6, 2))) * 30
    mean_j, std_j = (np.asarray(a) for a in setup.actor_def.apply(p["actor"], obs))
    x_t = mean_j + std_j * big
    y = np.tanh(x_t)
    assert (np.abs(y) > 0.999).any()
    t_action, t_logp = agent.actor.sample_and_log_prob(torch.from_numpy(obs), torch.from_numpy(big.astype(np.float32)))
    want = (-((x_t - mean_j) ** 2) / (2 * std_j**2) - np.log(std_j) - 0.5 * np.log(2 * np.pi)
            - np.log(1.0 * (1 - y**2) + 1e-6)).sum(-1, keepdims=True)
    np.testing.assert_allclose(t_action.detach().numpy(), y, atol=1e-6)
    np.testing.assert_allclose(t_logp.detach().numpy(), want, atol=1e-3, rtol=1e-5)
    q = setup.critic_def.apply(p["critic"], obs, np.asarray(action))
    act = torch.from_numpy(np.asarray(action))
    t_q = agent.critic(torch.from_numpy(obs), act)
    assert t_q.shape == q.shape == (6, 2)
    np.testing.assert_allclose(t_q.detach().numpy(), q, atol=1e-5, rtol=1e-5)
    # leading batch axes stay leading, the ensemble axis last
    q3 = agent.critic(torch.from_numpy(obs.reshape(2, 3, 10)), act.reshape(2, 3, 2))
    np.testing.assert_allclose(q3.detach().numpy().reshape(6, 2), q, atol=1e-5, rtol=1e-5)
    back = leaves(dump_trees(sac_spec(agent)))
    for path, value in leaves(p).items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


# --- the gradient steps -----------------------------------------------------


def jax_keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), G)


def eps_of(keys, b=B, act_dim=2):
    """The JAX step's one normal draw a gradient step (``sample_and_log_prob``
    at the next and the current observations share the key)."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (b, act_dim))) for k in keys]))


def adam_moments(opt_state):
    """``{path: array}`` of ``mu`` and ``nu`` of an optax (or the port's
    optax-layout) Adam state."""
    node = opt_state[0]
    mu, nu = (node.mu, node.nu) if hasattr(node, "mu") else (node.fields[1], node.fields[2])
    return {**{"mu" + k: v for k, v in leaves(mu).items()}, **{"nu" + k: v for k, v in leaves(nu).items()}}


def check_moments(ours, theirs, rel=1e-4):
    mine, want = adam_moments(ours), adam_moments(theirs)
    assert sorted(mine) == sorted(want)
    scale = {k: max(float(np.abs(v).max()), 1e-30) for k, v in want.items()}
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], atol=rel * scale[k], rtol=1e-3, err_msg=k)


class Steps:
    """The JAX step and the port's from the same params, optimizer state
    and (optionally) config overrides."""

    def __init__(self, setup, extra=(), bf16_true=False):
        self.setup = setup
        self.cfg, self.jax_cfg = compose(TINY + list(extra)), jax_compose(TINY + list(extra))
        self.jax_opts = setup.jax_optimizers()
        dtype = jnp.bfloat16 if bf16_true else jnp.float32
        self.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), setup.params)
        self.opt_states = {"actor": self.jax_opts["actor"].init(self.params["actor"]),
                           "critic": self.jax_opts["critic"].init(self.params["critic"]),
                           "alpha": self.jax_opts["alpha"].init(self.params["log_alpha"])}
        self.jax_step = jax_make_train_step(setup.actor_def, setup.critic_def, self.jax_opts, self.jax_cfg, _Mesh(),
                                            setup.target_entropy)
        # the port's weights: the same values (bf16-rounded under bf16-true)
        agent, _ = build_agent(self.cfg, OBS_SPACE, ACT_SPACE,
                               jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), self.params), "cpu")
        if bf16_true:
            for p in agent.parameters():
                p.data = p.data.to(torch.bfloat16)
        self.agent = agent
        self.optimizers = setup.optimizers(agent)
        self.step = make_train_step(agent, self.optimizers, self.cfg, -2.0)

    def run(self, data, seed):
        keys = jax_keys(seed)
        out = self.jax_step(self.params, self.opt_states, jax.tree_util.tree_map(jnp.asarray, data), keys)
        self.params, self.opt_states = out[0], out[1]
        metrics = self.step(torch_tree(data), eps_of(keys))
        return np.asarray(out[2]), {k: float(v) for k, v in out[3].items()}, metrics.numpy()

    def check_trees(self, atol=1e-5, rtol=1e-5):
        got = leaves(dump_trees(sac_spec(self.agent)))
        for path, value in leaves(self.params).items():
            np.testing.assert_allclose(got[path], value, atol=atol, rtol=rtol, err_msg=path)

    def check_optimizers(self, rel=1e-4):
        spec = sac_spec(self.agent)
        specs = {"actor": spec["actor"], "critic": spec["critic"], "alpha": spec["log_alpha"]}
        for name, opt in self.optimizers.items():
            ours = optax_state(opt, specs[name], clip=False)[0]
            assert int(ours[0].fields[0]) == int(self.opt_states[name][0].count)
            check_moments(ours, self.opt_states[name], rel)


def test_two_train_calls_match_the_jax_step_in_fp32(setup):
    """Two calls of two gradient steps each: the metric vector, the health
    stats per module, all four trees (the target critic's Polyak average
    included) and Adam's moments of the three optimizers."""
    steps = Steps(setup)
    for call in range(2):
        jax_metrics, jax_health, metrics = steps.run(batch(10 + call), 20 + call)
        np.testing.assert_allclose(metrics[:5], jax_metrics, rtol=1e-5, atol=1e-6)
        health = dict(zip(steps.step.health_names, metrics[5:]))
        assert sorted(health) == sorted(jax_health) and "module/alpha/update_ratio" in health
        for k, v in jax_health.items():
            tol = 1e-6 if k.endswith("dead_frac") else 1e-4
            np.testing.assert_allclose(health[k], v, rtol=tol, atol=tol / 10, err_msg=k)
        steps.check_trees()
        steps.check_optimizers()


def test_a_poisoned_batch_under_skip_update_leaves_everything_as_it_was(setup):
    """``diagnostics.sentinel.policy=skip_update``: a NaN reward makes both
    steps of the call non-finite; the parameters and every optimizer state
    tensor come back bit-identical, and the JAX step agrees."""
    steps = Steps(setup, ["diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=skip_update"])
    steps.run(batch(30), 31)  # one clean call first: the state is not init's
    before = [t.detach().clone() for t in steps.agent.parameters()]
    opt_before = [t.clone() for o in steps.optimizers.values() for s in o.state.values() for t in s.values()]
    jax_before = leaves(steps.params)
    data = batch(32)
    data["rewards"][:, 1, 0] = np.nan
    jax_metrics, _, metrics = steps.run(data, 33)
    assert metrics[4] == jax_metrics[4] == 2.0
    for a, b in zip(before, steps.agent.parameters()):
        assert torch.equal(a, b)
    after = [t for o in steps.optimizers.values() for s in o.state.values() for t in s.values()]
    assert all(torch.equal(a, b) for a, b in zip(opt_before, after))
    for path, value in leaves(steps.params).items():
        np.testing.assert_array_equal(value, jax_before[path], err_msg=path)
    steps.check_trees()


@pytest.mark.parametrize("precision", ["bf16-mixed", "bf16-true"])
def test_two_train_calls_match_the_jax_step_in_bf16(setup, precision):
    """The bf16 steps: the losses within 4 bf16 steps (2^-6 relative) of
    the JAX ones (the layers round at each output, in orders the two
    compilers choose), the parameters within 8 bf16 steps of each tree's
    scale; the fp32 masters (``bf16-mixed``) or bf16 weights
    (``bf16-true``) as the JAX step keeps them."""
    steps = Steps(setup, [f"fabric.precision={precision}"], bf16_true=precision == "bf16-true")
    for call in range(2):
        jax_metrics, _, metrics = steps.run(batch(40 + call), 50 + call)
        scale = np.maximum(np.abs(jax_metrics[:3]), 1.0)
        np.testing.assert_allclose(metrics[:3], jax_metrics[:3], rtol=0, atol=2**-6 * scale.max())
        assert metrics[4] == jax_metrics[4] == 0
    got = leaves(dump_trees(sac_spec(steps.agent)))
    for path, value in leaves(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), steps.params)).items():
        assert got[path].dtype == np.float32
        np.testing.assert_allclose(got[path], value, rtol=0, atol=8 * 2**-8 * max(float(np.abs(value).max()), 1e-3),
                                   err_msg=path)
    want_dtype = torch.bfloat16 if precision == "bf16-true" else torch.float32
    assert all(p.dtype == want_dtype for p in steps.agent.parameters())


# --- the loop, checkpoints and serving ---------------------------------------

RUN = ["exp=sac", "env.capture_video=False", "fabric.accelerator=cpu", "env.num_envs=2", "algo.hidden_size=8",
       "algo.per_rank_batch_size=4", "algo.learning_starts=8", "algo.total_steps=24", "buffer.size=32",
       "metric.logger=null", "metric.log_every=8", "checkpoint.every=12", "algo.run_test=False", "seed=3"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port SAC run on ``LunarLanderContinuous-v3`` (gymnasium + Box2D):
    12 iterations of 2 envs, a checkpoint (with the replay buffer) after
    the 6th and the 12th."""
    out = cli.run(RUN + [f"root_dir={tmp_path_factory.mktemp('sac_port')}"])
    assert len(out["checkpoints"]) == 2 and out["gradient_steps"] > 0
    return out


def _jax_restore(ckpt, setup):
    """The checkpoint as the JAX loop restores it: the agent, then the optax
    states into ``init``'s tree."""
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    state = jax_load_state(ckpt)
    params = jax.tree_util.tree_map(jnp.asarray, state["agent"])
    opts = setup.jax_optimizers()
    init = {"actor": opts["actor"].init(params["actor"]), "critic": opts["critic"].init(params["critic"]),
            "alpha": opts["alpha"].init(params["log_alpha"])}
    opt_states = jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=getattr(ref, "dtype", None)),
                                        init, state["opt_states"])
    return state, params, opt_states


LUNAR_OBS = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (8,), np.float32)})
LUNAR_GYM_OBS = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (8,), np.float32)})


def _lunar_setup():
    return Setup([o for o in RUN if not o.startswith("fabric")], LUNAR_GYM_OBS)


def _one_step_each(ckpt):
    """One train call of two gradient steps from a checkpoint in each
    package, restored as each loop restores it."""
    s = _lunar_setup()
    state, params, opt_states = _jax_restore(ckpt, s)
    port_state = load_state(ckpt)
    jax_step = jax_make_train_step(s.actor_def, s.critic_def, s.jax_optimizers(), s.jax_cfg, _Mesh(), -2.0)
    agent, _ = build_agent(s.cfg, LUNAR_OBS, ACT_SPACE, port_state["agent"], "cpu")
    optimizers = s.optimizers(agent)
    spec = sac_spec(agent)
    for name, opt in optimizers.items():
        opt.load_state_dict(optimizer_state_dict(port_state["opt_states"][name], opt,
                                                 {"actor": spec["actor"], "critic": spec["critic"],
                                                  "alpha": spec["log_alpha"]}[name]))
    step = make_train_step(agent, optimizers, s.cfg, -2.0)
    data = batch(60, obs_dim=8)
    keys = jax_keys(61)
    out = jax_step(params, opt_states, jax.tree_util.tree_map(jnp.asarray, data), keys)
    metrics = step(torch_tree(data), eps_of(keys)).numpy()
    np.testing.assert_allclose(metrics[:5], np.asarray(out[2]), rtol=1e-5, atol=1e-6)
    got = leaves(dump_trees(sac_spec(agent)))
    for path, value in leaves(out[0]).items():
        np.testing.assert_allclose(got[path], np.asarray(value), atol=1e-5, rtol=1e-5, err_msg=path)
    return state


def test_a_port_checkpoint_verifies_and_resumes_in_the_jax_package(port_run):
    """The JAX ``verify_checkpoint`` accepts the port's manifest; the JAX
    loop's restore reads the agent, the three Adam states and the replay
    buffer, and its next train call matches the port's."""
    from sheeprl_tpu.data.buffers import ReplayBuffer as JaxRB
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint

    ckpt = port_run["checkpoints"][0]
    assert jax_verify_checkpoint(ckpt) == (True, "verified")
    state = _one_step_each(ckpt)
    assert sorted(k for k in state if k != "rb") == sorted(
        ["agent", "opt_states", "ratio", "iter_num", "policy_step", "last_log", "last_checkpoint", "batch_size"])
    rb = JaxRB(32, 2, obs_keys=("observations",))
    rb.load_state_dict(state["rb"])
    assert rb["observations"].shape == (32, 2, 8) and rb["truncated"][5].all()  # the last row, marked


def test_a_jax_checkpoint_resumes_and_evaluates_in_the_port(tmp_path, monkeypatch):
    """The JAX package's SAC run writes a checkpoint; the next train call
    from it matches in both packages, the port's ``run`` resumes from it
    (the replay buffer and the Ratio included) and trains on, and ``eval``
    scores it."""
    from sheeprl_tpu.cli import run as jax_run

    monkeypatch.chdir(tmp_path)
    jax_run(RUN + ["root_dir=jax_sac"])
    ckpts = sorted(tmp_path.rglob("*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [int(p.name.split("_")[1]) for p in ckpts] == [12, 24]
    _one_step_each(str(ckpts[0]))
    out = cli.run(RUN + [f"checkpoint.resume_from={ckpts[0]}", "root_dir=port_resumed"])
    assert out["start_iter"] == 7 and out["policy_steps"] == 24 and out["gradient_steps"] > 0
    assert np.isfinite(out["metric_rows"]).all()
    assert np.isfinite(cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"]))


def test_run_trains_logs_and_evaluates(port_run):
    rows = port_run["metric_rows"]
    assert rows.shape[1] == 4 and np.isfinite(rows).all() and (port_run["nonfinite_updates"] == 0).all()
    assert set(port_run["health_rows"]) >= {"grad_norm", "update_ratio", "dead_frac"}
    assert any("Loss/value_loss" in m for m in port_run["logged"])
    assert all(m["Time/sps_env_interaction"] > 0 for m in port_run["logged"])
    assert np.isfinite(cli.evaluation([f"checkpoint_path={port_run['checkpoints'][-1]}", "fabric.accelerator=cpu"]))


def test_serving_handle_acts_as_the_jax_handle(setup):
    from sheeprl_tpu.serving.loader import _sac_handle
    from sheeprl_tpu_torch.serving.loader import build_policy

    jax_handle = _sac_handle(setup.jax_cfg, GYM_OBS, GYM_ACT, setup.params)
    handle = build_policy(setup.cfg, OBS_SPACE, ACT_SPACE, setup.params, "cpu")
    assert handle.algo == jax_handle.algo == "sac" and not handle.stateful
    assert handle.obs_spec == jax_handle.obs_spec and handle.action_shape == jax_handle.action_shape == (2,)
    rng = np.random.default_rng(5)
    rows = [handle.validate({"state": rng.normal(size=10)}) for _ in range(3)]
    obs = handle.assemble(rows, 4)
    key = jax.random.PRNGKey(6)
    for greedy in (True, False):
        want = np.asarray(jax.jit(jax_handle.make_step(greedy))(setup.params, jax_handle.assemble(rows, 4), key))
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, (4, 2))))
        got = handle.make_step(greedy)(handle.params, {k: torch.from_numpy(v) for k, v in obs.items()}, None, noise)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_serve_answers_a_port_checkpoint_over_http_as_the_jax_handle(port_run):
    import json
    import threading
    import urllib.request

    from sheeprl_tpu.serving.loader import _sac_handle
    from sheeprl_tpu_torch.serving.server import ServeApp

    ckpt = port_run["checkpoints"][-1]
    cfg, path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu",
                                          "serving.batch_buckets=[4]"])
    app = ServeApp(cfg, path, device)
    host, port = app.start()
    rng = np.random.default_rng(8)
    states = [rng.normal(size=8).astype(np.float32) for _ in range(4)]
    replies = {}

    def client(i):
        body = json.dumps({"obs": {"state": states[i].tolist()}, "greedy": True}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/act", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            replies[i] = (resp.status, json.loads(resp.read()))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        app.close()
    assert sorted(replies) == [0, 1, 2, 3] and all(status == 200 for status, _ in replies.values())
    s = _lunar_setup()
    jax_handle = _sac_handle(s.jax_cfg, LUNAR_GYM_OBS, GYM_ACT, load_state(ckpt)["agent"])
    step = jax.jit(jax_handle.make_step(True))
    for i, (_, body) in replies.items():
        want = np.asarray(step(jax_handle.params, states[i][None], jax.random.PRNGKey(0)))[0]
        np.testing.assert_allclose(np.asarray(body["action"], np.float32), want, atol=1e-6)


@pytest.mark.parametrize("option", ["algo.offline.enabled=True", "algo.offline.cql_alpha=1.0",
                                    "model_manager.disabled=False", "metric.profiler.enabled=True",
                                    "fabric.devices=2"])
def test_run_refuses_what_it_does_not_port(tmp_path, option):
    if option == "algo.offline.cql_alpha=1.0":
        # ported: online, the penalty applies to the critic update too, as
        # in the JAX package, whose check_configs warns of it
        with pytest.warns(UserWarning, match="cql_alpha is set but algo.offline.enabled=false"):
            out = cli.run(RUN + [option, f"root_dir={tmp_path}"])
        assert out["family"].cql_samples == 4 and np.isfinite(out["metric_rows"]).all()
        return
    if option == "algo.offline.enabled=True":
        # ported: routed to the offline loop, which needs a dataset (the JAX gate)
        with pytest.raises(ValueError, match="requires algo.offline.dataset_dir"):
            cli.run(RUN + [option, f"root_dir={tmp_path}"])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
        cli.run(RUN + [option, f"root_dir={tmp_path}"])
