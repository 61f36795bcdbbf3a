"""The port's DreamerV1 against the JAX package's, on the CPU at a tiny
width: the Gaussian latent, the KL and the lambda targets, two consecutive
gradient steps from converted params with DreamerV1's Gaussian noise
injected (discrete, and continuous with the continue head), the converter's
three trees, checkpoints crossing between the two packages' loops, and
``run`` with ``eval``, resume and ``serve``'s refusal.

The noise follows ``make_train_step``'s own key splits
(``dreamer_v1.py:75,86,138``): the dynamic scan's ``(prior, posterior)``
standard-normal draws, and per imagined step the action's draw and the
prior's.  DreamerV1's GRU has no LayerNorm: its step launches no kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sheeprl_tpu.algos.dreamer_v1 import loss as jax_loss
from sheeprl_tpu.algos.dreamer_v1 import utils as jax_utils
from sheeprl_tpu.algos.dreamer_v1.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v1 import loss as port_loss
from sheeprl_tpu_torch.algos.dreamer_v1 import utils as port_utils
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import METRIC_ORDER, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import load_learner_state, make_optimizers
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.interop.flax_params import optax_state
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_dreamer_v2 import OBS, VECTOR_ONLY, _spaces
from test_torch_dv3_train import _jit_build, _leaves, _record_margins, _t
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T, B, H = 4, 2, 3
STOCH, REC = 4, 8
TINY = [
    "exp=dreamer_v1",
    "env=dummy",
    "env.capture_video=False",
    "env.screen_size=16",
    "algo.dense_units=8",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    f"algo.world_model.stochastic_size={STOCH}",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}",
    f"algo.horizon={H}",
    "run_name=tiny",
]
TREES = ("world_model", "actor", "critic")


class _Setup:
    def __init__(self, env_id: str, is_continuous: bool, extra=()):
        overrides = TINY + [f"env.id={env_id}", *extra]
        self.jax_cfg, self.cfg = jax_compose(overrides), compose(overrides)
        self.actions_dim, self.is_continuous = (2,), is_continuous
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
        self.step = jax_make_train_step(self.wm_def, self.actor_def, self.critic_def, self.opts, self.jax_cfg)

    def agent(self, trees=None):
        return build_agent(self.actions_dim, self.is_continuous, self.cfg, self.obs_space,
                           trees if trees is not None else self.params, "cpu")

    def batch(self, seed: int):
        rng = np.random.default_rng(seed)
        actions = np.clip(rng.normal(size=(T, B, 2)), -1, 1) if self.is_continuous else \
            np.eye(2)[rng.integers(0, 2, (T, B))]
        terminated = np.zeros((T, B, 1))
        terminated[2, 0] = 1.0
        out = {"actions": actions, "rewards": rng.normal(size=(T, B, 1)), "terminated": terminated,
               "is_first": np.zeros((T, B, 1))}
        for k in self.obs_space.keys():
            out[k] = (rng.integers(0, 256, (T, B) + OBS[k]) / 255.0 - 0.5 if k == "rgb"
                      else rng.normal(size=(T, B) + OBS[k]))
        return {k: v.astype(np.float32) for k, v in out.items()}

    def noise(self, key):
        setup = self

        def draw(key):
            k_wm, k_img = jax.random.split(key)
            pairs = [jax.random.split(k) for k in jax.random.split(k_wm, T)]
            img = [jax.random.split(k) for k in jax.random.split(k_img, H)]  # (k_act, k_dyn)

            def actor_noise(k):
                if setup.is_continuous:
                    return [jax.random.normal(k, (T * B, 2))]
                return [jax.random.gumbel(jax.random.fold_in(k, 0), (T * B, 2))]

            return {
                "dynamic": (jnp.stack([jax.random.normal(p[0], (B, STOCH)) for p in pairs]),
                            jnp.stack([jax.random.normal(p[1], (B, STOCH)) for p in pairs])),
                "imagination": jnp.stack([jax.random.normal(k[1], (T * B, STOCH)) for k in img]),
                "actor": [actor_noise(k[0]) for k in img],
            }

        return jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), jax.jit(draw)(key))


@pytest.fixture(scope="module")
def setups():
    return {}


def _setup(setups, name: str) -> _Setup:
    if name not in setups:
        setups[name] = {
            "disc": lambda: _Setup("discrete_dummy", False),
            "cont": lambda: _Setup("continuous_dummy", True, VECTOR_ONLY + ["algo.world_model.use_continues=True"]),
        }[name]()
    return setups[name]


def _assert_trees_and_moments(params, opt_states, agent, optimizers):
    want, got = _leaves({k: params[k] for k in TREES}), _leaves(agent.trees())
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    for name in TREES:
        adam = opt_states[name][1][0]
        mine = optax_state(optimizers[name], agent.optimizer_spec(name))[1][0]
        w, g = _leaves({"mu": adam.mu, "nu": adam.nu}), _leaves({"mu": mine.fields[1], "nu": mine.fields[2]})
        assert sorted(w) == sorted(g)
        scale = max(float(np.abs(v).max()) for v in w.values())
        for path in w:
            np.testing.assert_allclose(g[path], w[path], atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")


def test_kl_loss_and_lambda_targets_match():
    rng = np.random.default_rng(2)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pm, qm = f32(rng.normal(size=(T, B, STOCH))), f32(rng.normal(size=(T, B, STOCH)))
    ps, qs = f32(rng.random((T, B, STOCH)) + 0.1), f32(rng.random((T, B, STOCH)) + 0.1)
    np.testing.assert_allclose(port_loss.kl_normal(_t(pm), _t(ps), _t(qm), _t(qs)).numpy(),
                               np.asarray(jax_loss.kl_normal(pm, ps, qm, qs)), rtol=1e-5, atol=1e-6)
    recon = {"state": f32(rng.normal(size=(T, B, 5)))}
    obs = {"state": f32(recon["state"] + 0.2)}
    rm, rw, logits = f32(rng.normal(size=(T, B, 1))), f32(rng.normal(size=(T, B, 1))), f32(rng.normal(size=(T, B, 1)))
    targets = f32((rng.random((T, B, 1)) < 0.7) * 0.99)
    for free_nats in (0.5, 50.0):
        want = jax_loss.reconstruction_loss(recon, obs, rm, rw, (pm, ps), (qm, qs), free_nats, 1.2,
                                            jax_loss.Bernoulli(jnp.asarray(logits), event_dims=1), targets, 10.0)
        got = port_loss.reconstruction_loss({k: _t(v) for k, v in recon.items()}, {k: _t(v) for k, v in obs.items()},
                                            _t(rm), _t(rw), (_t(pm), _t(ps)), (_t(qm), _t(qs)), free_nats, 1.2,
                                            port_loss.Bernoulli(_t(logits), event_dims=1), _t(targets), 10.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    values, conts, rews = (f32(rng.normal(size=(H, 6, 1))), f32(rng.random((H, 6, 1))),
                           f32(rng.normal(size=(H, 6, 1))))
    want = jax_utils.compute_lambda_values(rews, values, conts, values[-1], H, 0.95)
    got = port_utils.compute_lambda_values(_t(rews), _t(values), _t(conts), _t(values[-1]), H, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["disc", "cont"])
def test_two_train_steps_match_make_train_step(name, setups, monkeypatch):
    setup = _setup(setups, name)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: setup.opts[k].init(params[k]) for k in setup.opts}
    agent = setup.agent()
    cells = [m for m in agent.world_model.modules() if isinstance(m, LayerNormGRUCell)]
    assert cells and all(c.norm is None and c.linear.bias is not None for c in cells)  # the plain GRU
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, setup.is_continuous)
    _record_margins(monkeypatch)
    batch = setup.batch(11)
    key = jax.random.PRNGKey(5)
    launches = fused_layernorm_gru.launches
    for i in range(2):
        key, sub = jax.random.split(key)
        params, opt_states, jax_metrics = setup.step(params, opt_states, {k: jnp.asarray(v) for k, v in batch.items()},
                                                     sub)
        _, metrics = step({}, {k: _t(v) for k, v in batch.items()}, 0.0, None, setup.noise(sub))
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}: {METRIC_ORDER}")
    assert fused_layernorm_gru.launches == launches
    _assert_trees_and_moments(params, opt_states, agent, optimizers)


def test_converter_round_trips_the_three_trees(setups):
    setup = _setup(setups, "disc")
    back, want = _leaves(setup.agent().trees()), _leaves({k: setup.params[k] for k in TREES})
    assert sorted(back) == sorted(want) and "target_critic" not in setup.params
    for path, value in want.items():
        assert back[path].dtype == value.dtype and np.array_equal(back[path], value), path


RUN = TINY + [
    "env.id=discrete_dummy",
    "fabric.accelerator=cpu",
    "algo.learning_starts=8",
    "algo.replay_ratio=0.5",
    "algo.total_steps=32",
    "buffer.size=64",
    "env.num_envs=2",
    "metric.log_every=8",
    "metric.logger=null",
    "checkpoint.every=8",
    "checkpoint.save_last=False",
]


def test_checkpoints_cross_between_the_two_packages_loops(setups, tmp_path, monkeypatch):
    """The JAX loop's checkpoint resumes a port run, and one step of each
    package from it agrees; the port's checkpoint passes the JAX
    ``verify_checkpoint`` and, restored as the JAX loop restores it, one
    step of each package agrees."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    monkeypatch.chdir(tmp_path)
    setup = _setup(setups, "disc")
    jax_run(RUN + ["root_dir=jax_dv1", "metric.log_level=0", "algo.run_test=False"])
    jax_ckpt = next((tmp_path / "logs").rglob("ckpt_16_0.ckpt"))
    jax_state = jax_load_state(str(jax_ckpt))
    assert {*TREES, "opt_states", "ratio", "iter_num", "rb"} <= set(jax_state) and "target_critic" not in jax_state

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
                                                     key)
        _, metrics = step({}, {k: _t(v) for k, v in batch.items()}, 0.0, None, setup.noise(key))
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4)
        _assert_trees_and_moments(params, opt_states, agent, optimizers)

    one_step_each(load_state(str(jax_ckpt)), jax_state)
    out = cli.run(RUN + ["root_dir=port_resumed", f"checkpoint.resume_from={jax_ckpt}"])
    assert out["start_iter"] == jax_state["iter_num"] + 1 and out["gradient_steps"] > 0
    port_ckpt = out["checkpoints"][-1]
    assert jax_verify_checkpoint(port_ckpt) == (True, "verified")
    one_step_each(load_state(port_ckpt), jax_load_state(port_ckpt))


def test_run_trains_resumes_evaluates_and_refuses_what_it_does_not_port(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.serving.loader import load_policy

    monkeypatch.chdir(tmp_path)
    out = cli.run(RUN + ["algo.run_test=True"])
    assert out["gradient_steps"] > 0 and out["test_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    ckpt = out["checkpoints"][0]
    assert set(load_state(ckpt)) >= {*TREES, "opt_states", "rb"}
    resumed = cli.run(RUN + [f"checkpoint.resume_from={ckpt}", "root_dir=resumed"])
    assert resumed["gradient_steps"] > 0
    assert np.isfinite(cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"]))
    with pytest.raises(ValueError, match="no servable adapter"):
        load_policy(compose(RUN), ckpt, "cpu")
    with pytest.raises(NotImplementedError, match="skip_update"):
        cli.run(RUN + ["diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=skip_update"])
