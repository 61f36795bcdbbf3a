"""The port's DreamerV2 against the JAX package's, on the CPU at a tiny
width: the loss and the bootstrapped lambda returns, two consecutive
gradient steps from converted params (discrete with the continue head,
continuous at ``objective_mix=0``; ``bf16-mixed`` in
``test_torch_dreamer_v2_precision.py``), the hard target update, the converter's trees and optax states both ways, checkpoints
crossing between the two packages' loops, and ``run`` through both buffer
types with ``eval``, resume and ``serve``'s refusal.

Random draws go through injected noise taken from the JAX keys with
``make_train_step``'s own splits (``dreamer_v2.py:78,99,141-142``): the
dynamic scan's ``(prior, posterior)`` Gumbel noise, and per imagined step
the action's draw and the prior's.  Every argmax the port takes in a
compared fp32 step is checked to separate the top two classes by far more
than the tolerance (``test_torch_dv3_train._record_margins``).
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sheeprl_tpu.algos.dreamer_v2 import loss as jax_loss
from sheeprl_tpu.algos.dreamer_v2 import utils as jax_utils
from sheeprl_tpu.algos.dreamer_v2.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v2 import loss as port_loss
from sheeprl_tpu_torch.algos.dreamer_v2 import utils as port_utils
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import METRIC_ORDER, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import load_learner_state, make_optimizers
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_params import optax_state, optimizer_state_dict
from sheeprl_tpu_torch.ops.distributions import Bernoulli
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_dv3_train import _jit_build, _leaves, _record_margins, _t
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T, B, H = 4, 2, 3
STOCH, DISCRETE, REC = 4, 4, 8
TINY = [
    "exp=dreamer_v2",
    "env=dummy",
    "env.capture_video=False",
    "env.screen_size=16",
    "algo.dense_units=8",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    f"algo.world_model.discrete_size={DISCRETE}",
    f"algo.world_model.stochastic_size={STOCH}",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}",
    f"algo.horizon={H}",
    "run_name=tiny",
]
VECTOR_ONLY = ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]"]
OBS = {"rgb": (3, 16, 16), "state": (10,)}
TREES = ("world_model", "actor", "critic", "target_critic")


def _spaces(keys):
    gym_obs = gym.spaces.Dict({k: gym.spaces.Box(0, 255, OBS[k], np.uint8) if k == "rgb"
                               else gym.spaces.Box(-20, 20, OBS[k], np.float32) for k in keys})
    obs = spaces.Dict({k: spaces.Box(0, 255, OBS[k], np.uint8) if k == "rgb"
                       else spaces.Box(-20, 20, OBS[k], np.float32) for k in keys})
    return gym_obs, obs


class _Setup:
    """The JAX agent (built once under ``jax.jit``, every leaf perturbed)
    and its jitted train step; the port's agent on converted weights."""

    def __init__(self, env_id: str, actions_dim, is_continuous: bool, extra=()):
        overrides = TINY + [f"env.id={env_id}", *extra]
        self.jax_cfg, self.cfg = jax_compose(overrides), compose(overrides)
        self.actions_dim, self.is_continuous = tuple(actions_dim), is_continuous
        keys = list(self.cfg.algo.cnn_keys.encoder) + list(self.cfg.algo.mlp_keys.encoder)
        self.gym_obs, self.obs_space = _spaces(keys)

        def build():
            wm_def, actor_def, critic_def, params = jax_build_agent(None, self.actions_dim, is_continuous,
                                                                    self.jax_cfg, self.gym_obs)
            return params, wm_def, actor_def, critic_def

        params, self.wm_def, self.actor_def, self.critic_def = _jit_build(build)
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params)
        self.opts = {k: optax.chain(optax.clip_by_global_norm(self.jax_cfg.algo[k].clip_gradients),
                                    jax_instantiate(self.jax_cfg.algo[k].optimizer))
                     for k in ("world_model", "actor", "critic")}
        self.step = jax_make_train_step(self.wm_def, self.actor_def, self.critic_def, self.opts, self.jax_cfg,
                                        self.actions_dim, is_continuous)

    def agent(self, trees=None):
        return build_agent(self.actions_dim, self.is_continuous, self.cfg, self.obs_space,
                           trees if trees is not None else self.params, "cpu")

    def batch(self, seed: int):
        rng = np.random.default_rng(seed)
        if self.is_continuous:
            actions = np.clip(rng.normal(size=(T, B, 2)), -1, 1)
        else:
            actions = np.eye(2)[rng.integers(0, 2, (T, B))]
        terminated = np.zeros((T, B, 1))
        terminated[2, 0] = 1.0
        is_first = np.zeros((T, B, 1))
        is_first[3, 0] = 1.0
        out = {"actions": actions, "rewards": rng.normal(size=(T, B, 1)), "terminated": terminated,
               "is_first": is_first}
        for k in self.obs_space.keys():
            out[k] = (rng.integers(0, 256, (T, B) + OBS[k]) / 255.0 - 0.5 if k == "rgb"
                      else rng.normal(size=(T, B) + OBS[k]))
        return {k: v.astype(np.float32) for k, v in out.items()}

    def noise(self, key, dtype=jnp.float32):
        """The draws the JAX step takes from ``key``, as port noise
        (``jax.random.categorical`` draws in the logits' dtype)."""
        setup = self

        def draw(key):
            k_wm, k_img = jax.random.split(key)
            pairs = [jax.random.split(k) for k in jax.random.split(k_wm, T)]
            img = [jax.random.split(k) for k in jax.random.split(k_img, H)]  # (k_act, k_dyn)

            def actor_noise(k):
                if setup.is_continuous:  # trunc_normal: a uniform draw
                    return [jax.random.uniform(k, (T * B, 2), dtype, minval=1e-6, maxval=1 - 1e-6)]
                return [jax.random.gumbel(jax.random.fold_in(k, i), (T * B, d), dtype)
                        for i, d in enumerate(setup.actions_dim)]

            return {
                "dynamic": (jnp.stack([jax.random.gumbel(p[0], (B, STOCH, DISCRETE), dtype) for p in pairs]),
                            jnp.stack([jax.random.gumbel(p[1], (B, STOCH, DISCRETE), dtype) for p in pairs])),
                "imagination": jnp.stack([jax.random.gumbel(k[1], (T * B, STOCH, DISCRETE), dtype) for k in img]),
                "actor": [actor_noise(k[0]) for k in img],
            }

        return jax.tree_util.tree_map(lambda a: _t(np.asarray(a).astype(np.float32)), jax.jit(draw)(key))


@pytest.fixture(scope="module")
def setups():
    return {}


def _setup(setups, name: str) -> _Setup:
    if name not in setups:
        setups[name] = {
            "continues": lambda: _Setup("discrete_dummy", (2,), False, ["algo.world_model.use_continues=True"]),
            "mix0": lambda: _Setup("continuous_dummy", (2,), True, VECTOR_ONLY + ["algo.actor.objective_mix=0"]),
        }[name]()
    return setups[name]


def _opt_leaves(opt_states) -> dict:
    return {name: _leaves({"mu": opt_states[name][1][0].mu, "nu": opt_states[name][1][0].nu})
            for name in ("world_model", "actor", "critic")}


def _port_opt_leaves(agent, optimizers) -> dict:
    out = {}
    for name in ("world_model", "actor", "critic"):
        adam = optax_state(optimizers[name], agent.optimizer_spec(name))[1][0]
        out[name] = _leaves({"mu": adam.fields[1], "nu": adam.fields[2]})
    return out


def _state_leaves(node) -> list:
    """``(class name, arrays)`` in order, of an optax state tree or of the
    port's stand-in for one."""
    if hasattr(node, "fields") or hasattr(node, "_fields"):
        fields = node.fields if hasattr(node, "fields") else tuple(node)
        return [type(node).__name__] + [x for f in fields for x in _state_leaves(f)]
    if isinstance(node, (tuple, list)):
        return [x for f in node for x in _state_leaves(f)]
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in [k, *_state_leaves(node[k])]]
    return [np.asarray(node)]


def _assert_trees_and_moments(params, opt_states, agent, optimizers):
    """Two Adam steps of at most lr (3e-4 / 8e-5) moved the params: 2e-6
    is a few percent of one step; the moments to 1e-4 of their scale."""
    want, got = _leaves({k: params[k] for k in TREES}), _leaves(agent.trees())
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    want, got = _opt_leaves(opt_states), _port_opt_leaves(agent, optimizers)
    for name in want:
        assert sorted(want[name]) == sorted(got[name])
        scale = max(float(np.abs(v).max()) for v in want[name].values())
        for path in want[name]:
            np.testing.assert_allclose(got[name][path], want[name][path], atol=1e-4 * scale, rtol=1e-3,
                                       err_msg=f"{name}{path}")


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kl_free_avg", [True, False])
def test_reconstruction_loss_and_lambda_values_match(kl_free_avg):
    rng = np.random.default_rng(3)
    recon = {"rgb": rng.normal(size=(T, B, 3, 4, 4)), "state": rng.normal(size=(T, B, 5))}
    obs = {k: v + 0.3 * rng.normal(size=v.shape) for k, v in recon.items()}
    reward_mean, rewards = rng.normal(size=(T, B, 1)), rng.normal(size=(T, B, 1))
    prior, post = rng.normal(size=(T, B, STOCH, DISCRETE)), rng.normal(size=(T, B, STOCH, DISCRETE))
    logits, targets = rng.normal(size=(T, B, 1)), (rng.random((T, B, 1)) < 0.8) * 0.99
    args = (0.8, 0.5, kl_free_avg, 1.3)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    want = jax_loss.reconstruction_loss(
        {k: jnp.asarray(f32(v)) for k, v in recon.items()}, {k: jnp.asarray(f32(v)) for k, v in obs.items()},
        jnp.asarray(f32(reward_mean)), jnp.asarray(f32(rewards)), jnp.asarray(f32(prior)), jnp.asarray(f32(post)),
        *args, jax_loss.Bernoulli(jnp.asarray(f32(logits)), event_dims=1), jnp.asarray(f32(targets)), 2.0)
    got = port_loss.reconstruction_loss(
        {k: _t(f32(v)) for k, v in recon.items()}, {k: _t(f32(v)) for k, v in obs.items()}, _t(f32(reward_mean)),
        _t(f32(rewards)), _t(f32(prior)), _t(f32(post)), *args, Bernoulli(_t(f32(logits)), event_dims=1),
        _t(f32(targets)), 2.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    values, conts, rews = rng.normal(size=(H + 1, 6, 1)), rng.random((H + 1, 6, 1)), rng.normal(size=(H + 1, 6, 1))
    for bootstrap in (None, values[-1:]):
        w = jax_utils.compute_lambda_values(jnp.asarray(f32(rews[:-1])), jnp.asarray(f32(values[:-1])),
                                            jnp.asarray(f32(conts[:-1])),
                                            None if bootstrap is None else jnp.asarray(f32(bootstrap)), H, 0.95)
        g = port_utils.compute_lambda_values(_t(f32(rews[:-1])), _t(f32(values[:-1])), _t(f32(conts[:-1])),
                                             None if bootstrap is None else _t(f32(bootstrap)), H, 0.95)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# two consecutive gradient steps against make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["continues", "mix0"])
def test_two_train_steps_match_make_train_step(name, setups, monkeypatch):
    """The first step's ``tau=1`` copies the critic into the target critic
    before anything else; the second's ``tau=0`` leaves the copy as it is."""
    setup = _setup(setups, name)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: setup.opts[k].init(params[k]) for k in setup.opts}
    agent = setup.agent()
    assert agent.world_model.rssm.recurrent_model.cell.linear.bias is None  # the GRU Dense has no bias
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, setup.is_continuous)
    _record_margins(monkeypatch)
    batch = setup.batch(11)
    key = jax.random.PRNGKey(5)
    # the dumped arrays are copies, not views of the live weights
    critic_before = _leaves(agent.trees()["critic"])
    for i, tau in enumerate((1.0, 0.0)):
        key, sub = jax.random.split(key)
        params, opt_states, jax_metrics = setup.step(params, opt_states, {k: jnp.asarray(v) for k, v in batch.items()},
                                                     sub, jnp.float32(tau))
        _, metrics = step({}, {k: _t(v) for k, v in batch.items()}, tau, None, setup.noise(sub))
        # fp32 losses over a few hundred terms; gradient norms of O(100)
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}: {METRIC_ORDER}")
        if i == 0:
            target = _leaves(agent.trees()["target_critic"])
            assert all(np.array_equal(target[p], critic_before[p]) for p in critic_before)
    _assert_trees_and_moments(params, opt_states, agent, optimizers)


# ---------------------------------------------------------------------------
# the converter and checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_converter_round_trips_the_four_trees_and_the_adamw_states(setups):
    setup = _setup(setups, "continues")
    agent = setup.agent()
    back, want = _leaves(agent.trees()), _leaves({k: setup.params[k] for k in TREES})
    assert sorted(back) == sorted(want)
    assert not any("initial_recurrent_state" in p for p in want)  # not learned in DreamerV2
    for path, value in want.items():
        assert back[path].dtype == value.dtype and np.array_equal(back[path], value), path
    # optax's adamw state (clip, (adam, decay, empty)) both ways, exactly
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    rng = np.random.default_rng(1)
    for name in ("world_model", "actor", "critic"):
        state = setup.opts[name].init(params[name])
        adam = state[1][0]
        state = (state[0], (adam._replace(count=jnp.asarray(3, jnp.int32),
                                          mu=jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), adam.mu),
                                          nu=jax.tree_util.tree_map(lambda a: rng.random(a.shape).astype(np.float32), adam.nu)),
                            *state[1][1:]))
        opt = make_optimizers(setup.cfg, agent)[name]
        opt.load_state_dict(optimizer_state_dict(jax.tree_util.tree_map(np.asarray, state), opt,
                                                 agent.optimizer_spec(name)))
        got, want = _state_leaves(optax_state(opt, agent.optimizer_spec(name))), _state_leaves(state)
        assert len(got) == len(want) and "ScaleByAdamState" in want
        for a, b in zip(got, want):
            assert (a == b) if isinstance(b, str) else (a.dtype == b.dtype and np.array_equal(a, b))


RUN = TINY + [
    "env.id=discrete_dummy",
    "fabric.accelerator=cpu",
    "algo.learning_starts=8",
    "algo.per_rank_pretrain_steps=1",
    "algo.replay_ratio=0.5",
    "algo.critic.per_rank_target_network_update_freq=2",
    "algo.total_steps=16",
    "buffer.size=32",
    "env.num_envs=2",
    "metric.log_every=8",
    "metric.logger=null",
    "checkpoint.every=8",
    "checkpoint.save_last=False",
]


def test_checkpoints_cross_between_the_two_packages_loops(setups, tmp_path, monkeypatch):
    """The JAX loop writes a checkpoint: the port resumes a run from it, and
    one step of each package from it agrees.  The port's checkpoint passes
    the JAX ``verify_checkpoint``, and restored as the JAX loop restores it,
    one step of each package agrees."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    monkeypatch.chdir(tmp_path)
    setup = _setup(setups, "continues")
    # a resume waits algo.learning_starts again and keeps algo.total_steps:
    # the mid-run checkpoint of a run that starts training early
    crossing = RUN + ["algo.world_model.use_continues=True", "algo.total_steps=32"]
    jax_run(crossing + ["root_dir=jax_dv2", "metric.log_level=0", "algo.run_test=False"])
    jax_ckpt = next((tmp_path / "logs").rglob("ckpt_16_0.ckpt"))
    jax_state = jax_load_state(str(jax_ckpt))
    assert {*TREES, "opt_states", "ratio", "iter_num", "rb"} <= set(jax_state) and "moments" not in jax_state

    def one_step_each(state, jax_tree_state):
        params = {k: jax.tree_util.tree_map(jnp.asarray, jax_tree_state[k]) for k in TREES}
        opt_states = {k: jax.tree_util.tree_map(lambda r, s: jnp.asarray(s, getattr(r, "dtype", None)),
                                                setup.opts[k].init(params[k]), jax_tree_state["opt_states"][k])
                      for k in setup.opts}
        agent = setup.agent({k: state[k] for k in TREES})
        optimizers = make_optimizers(setup.cfg, agent)
        assert load_learner_state(state, agent, optimizers, "cpu") == {}
        step = make_train_step(agent, optimizers, setup.cfg, False)
        batch, key = setup.batch(17), jax.random.PRNGKey(33)
        params, opt_states, jax_metrics = setup.step(params, opt_states, {k: jnp.asarray(v) for k, v in batch.items()},
                                                     key, jnp.float32(0.0))
        _, metrics = step({}, {k: _t(v) for k, v in batch.items()}, 0.0, None, setup.noise(key))
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4)
        _assert_trees_and_moments(params, opt_states, agent, optimizers)

    one_step_each(load_state(str(jax_ckpt)), jax_state)
    out = cli.run(crossing + ["root_dir=port_resumed", f"checkpoint.resume_from={jax_ckpt}"])
    assert out["start_iter"] == jax_state["iter_num"] + 1 and out["gradient_steps"] > 0

    port_ckpt = out["checkpoints"][-1]
    assert jax_verify_checkpoint(port_ckpt) == (True, "verified")
    state = load_state(port_ckpt)
    assert "gradient_steps" not in state  # no counter, as the JAX checkpoint: every run restarts it
    one_step_each(state, jax_load_state(port_ckpt))


@pytest.mark.parametrize("buffer_type", ["sequential", "episode"])
def test_run_trains_resumes_evaluates_and_serve_refuses_it(buffer_type, tmp_path, monkeypatch):
    from sheeprl_tpu_torch.serving.loader import load_policy

    monkeypatch.chdir(tmp_path)
    # the first episodes (5 rows each) end before the first gradient step;
    # a resume waits algo.learning_starts again: long enough to train after it
    run = RUN + [f"buffer.type={buffer_type}", "buffer.prioritize_ends=True", "algo.run_test=True",
                 "algo.learning_starts=12", "algo.total_steps=28"]
    out = cli.run(run)
    assert out["gradient_steps"] > 0 and out["test_steps"] > 0
    assert out["metric_rows"].shape == (out["gradient_steps"], len(METRIC_ORDER))
    assert np.isfinite(out["metric_rows"]).all() and out["health_rows"] == {}
    ckpt = out["checkpoints"][0]
    state = load_state(ckpt)
    assert {*TREES, "opt_states", "rb"} <= set(state) and not {"moments", "gradient_steps"} & set(state)
    if buffer_type == "episode":
        assert {"cum_lengths", "open_episodes"} <= set(state["rb"])
    # the counter of the hard target update restarts at 0 in the resumed
    # run, as the JAX loop's does: its first gradient step copies the critic
    # into the target.  A checkpoint an older port wrote holds the counter
    # (7 here, which would put the first copy at the run's second step): it
    # resumes, and the key is not read
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2
    from sheeprl_tpu_torch.parallel.runtime import Runtime

    taus, make_step, load = [], dreamer_v2.make_train_step, Runtime.load

    def recording(*args):
        step = make_step(*args)

        def recorded(moments, batch, tau, *rest):
            taus.append(tau)
            return step(moments, batch, tau, *rest)

        recorded.metric_order, recorded.health_names = step.metric_order, step.health_names
        return recorded

    monkeypatch.setattr(dreamer_v2, "make_train_step", recording)
    monkeypatch.setattr(Runtime, "load", lambda self, path: {**load(self, path), "gradient_steps": 7})
    resumed = cli.run(run + [f"checkpoint.resume_from={ckpt}", "root_dir=resumed"])
    assert resumed["start_iter"] == state["iter_num"] + 1 and resumed["gradient_steps"] > 0
    assert taus[0] == 1.0 and taus[1:] == [float(i % 2 == 0) for i in range(1, len(taus))]
    assert "gradient_steps" not in load_state(resumed["checkpoints"][-1])
    reward = cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"])
    assert np.isfinite(reward)
    with pytest.raises(ValueError, match="no servable adapter"):
        load_policy(compose(run), ckpt, "cpu")


def test_run_refuses_skip_update_and_unknown_buffer_types(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="skip_update"):
        cli.run(RUN + ["diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=skip_update"])
    with pytest.raises(ValueError, match="buffer type"):
        cli.run(RUN + ["buffer.type=uniform"])
    with pytest.raises(NotImplementedError, match="multi-device"):
        cli.run(RUN + ["fabric.devices=2"])
    # the JAX loop reads none of these, so the port runs with them set
    out = cli.run(RUN + ["model_manager.disabled=False"])
    assert out["gradient_steps"] > 0
