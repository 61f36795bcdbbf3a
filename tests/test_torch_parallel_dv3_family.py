"""The port's two-shard gradient steps of DreamerV3-JEPA and Plan2Explore-DV3
(exploration and finetuning) against the JAX ``make_train_step``
``shard_map``-ed over two of the suite's virtual CPU devices.

For each family: two consecutive steps from converted params, the port's as
two shards (a replica of the agent and optimizers each, run in lockstep by
``parallel/dp.py::run_shards``) on the shards' blocks of one global batch,
each shard's draws injected from the JAX key as the JAX step folds it.  The
JAX steps ``pmean`` every gradient tree and the metrics and take each
Moments' quantiles over every device's lambda values (``update_moments``
with ``axis_name``); JEPA's targets move by the moving average of the
reduced weights.  After each step the replicas hold the same bytes and
shard 0's metrics agree with the JAX step's; after both, the parameters
(JEPA's targets too), every optimizer's Adam moments and the Moments (the
exploration critics' and the task's).  The tolerances are each family's
one-device parity test's: metrics 1e-4, parameters 2e-6 absolute, Adam's
moments 1e-4 of each tree's scale, Moments 1e-5.  The families run on the
vector observation (the CNN's compile would double the file's time); each
JAX two-device step is compiled once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import test_torch_dv3_train as dv3
import test_torch_jepa as tj
import test_torch_p2e_dv3 as tp3
from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER
from test_torch_parallel_dv2_family import _jit_once, _mesh, _two_steps
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

VECTOR = ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]"]


def _check_moments(state, moments):
    for path, value in dv3._leaves(tp3._moments_tree(moments)).items():
        got = dv3._leaves(tp3._moments_tree(jax.tree_util.tree_map(lambda t: t.numpy(), state)))[path]
        np.testing.assert_allclose(got, value, atol=1e-5, rtol=1e-5, err_msg=f"moments{path}")


def _jepa_noise(key):
    """The JEPA step's draws (``tj._step_noise``), the views' for the vector
    observation alone: ``make_two_views`` folds its key by the index of each
    key among the encoded ones."""
    noise = tj._step_noise(key)
    views = tj._view_noise(jax.random.split(key, 4)[3], {"state": jnp.zeros((dv3.T, dv3.B, 10))})
    noise["views"] = jax.tree_util.tree_map(lambda a: dv3._t(np.asarray(a)), views)
    return noise


def _jepa(built):
    from sheeprl_tpu.algos.dreamer_v3_jepa import dreamer_v3_jepa as jax_jepa
    from sheeprl_tpu_torch.algos.dreamer_v3_jepa.dreamer_v3_jepa import make_train_step

    s = built("jepa", lambda: tj._Setup(tj.TINY + VECTOR))
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    opts, opt_states = tj._jax_optimizers(s, params)
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_jepa.make_train_step(s.wm_def, s.actor_def, s.critic_def, opts, s.jax_cfg, tj.ACTIONS_DIM,
                                             False, mesh=_mesh())
    def jax_step(*args):
        return s.dp_step(*args)[:4]

    def jax_metrics_of(want):
        # Loss/jepa_loss: the JAX world-model loss less its reconstruction terms
        return np.concatenate([np.asarray(want), [tj._jl(want, s.cfg)]]).astype(np.float32)

    params, opt_states, moments, agent, optimizers, state = _two_steps(
        jax_step, params, opt_states, jax_dv3_utils.init_moments_state(), s.agent(),
        lambda a, o: make_train_step(a, o, s.cfg, False), s.cfg, lambda seed: dv3._batch(s, seed),
        _jepa_noise, (1.0, 0.02), METRIC_ORDER + ["Loss/jepa_loss"], jax_metrics_of=jax_metrics_of)
    want, got = dv3._leaves({k: params[k] for k in tj.TREES}), dv3._leaves(agent.trees())
    assert sorted(got) == sorted(want) and any("target_encoder" in p for p in want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    ours = tj._adam_state_leaves(optimizers, agent)
    for name in ("world_model", "actor", "critic"):
        adam = opt_states[name][1][0]
        w = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path((adam.mu, adam.nu))}
        scale = max(float(np.abs(v).max()) for v in w.values())
        for path, value in w.items():
            np.testing.assert_allclose(ours[name][path], value, atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")
    _check_moments(state, moments)


def _p2e_exploration(built):
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_train_step, metric_order

    s = built("p2e_dv3", lambda: tp3._Setup("continuous"))  # the vector observation
    jax_ex = tp3.jax_ex
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_ex.make_train_step(s.wm_def, s.actor_def, s.critic_def, s.optimizers, s.jax_cfg,
                                           s.actions_dim, s.is_continuous, mesh=_mesh())
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    _, opt_states = jax_ex._make_optimizers(s.jax_cfg, params, None)
    params, opt_states, moments, agent, optimizers, state = _two_steps(
        s.dp_step, params, opt_states, jax_ex._init_moments(s.jax_cfg, None), s.agent(),
        lambda a, o: make_train_step(a, o, s.cfg, s.is_continuous), s.cfg, lambda seed: tp3._p2e_batch(s, seed),
        lambda key: tp3._noise(s, key), (1.0, 0.02), metric_order(s.critics_spec))
    tp3._assert_step_state(s, params, opt_states, moments, agent, optimizers, state)


def _p2e_finetuning(built):
    """The finetuning loop's agent (DreamerV3's four trees, trained, and an
    exploration actor that only acts) at DreamerV3's test widths, stepping
    as the JAX finetuning loop's step, which is DreamerV3's own
    (``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py`` imports it)."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning as ft

    s = built("dreamer_v3", lambda: dv3._Setup("continuous_dummy", (2,), True, VECTOR))
    cfg, jax_cfg = s.cfg, s.jax_cfg
    opts = {k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients),
                           jax_instantiate(jax_cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_make_train_step(s.wm_def, s.actor_def, s.critic_def, opts, jax_cfg, s.actions_dim,
                                        s.is_continuous, mesh=_mesh())
    explorer = ft.build_agent(s.actions_dim, True, cfg, dv3.OBS_SPACE, None, "cpu")
    agent = ft.build_agent(s.actions_dim, True, cfg, dv3.OBS_SPACE,
                           {**s.params, "actor_exploration": explorer.trees()["actor_exploration"]}, "cpu")
    acting = dv3._leaves(agent.trees()["actor_exploration"])
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    opt_states = {k: opts[k].init(params[k]) for k in opts}
    params, opt_states, moments, agent, optimizers, state = _two_steps(
        lambda *args: s.dp_step(*args)[:4], params, opt_states, jax_dv3_utils.init_moments_state(), agent,
        lambda a, o: make_train_step(a, o, cfg, True), cfg, lambda seed: dv3._batch(s, seed),
        lambda key: dv3._jax_noise(s, key), (1.0, 0.02), METRIC_ORDER)
    trees = agent.trees()
    after = dv3._leaves(trees.pop("actor_exploration"))
    assert all(np.array_equal(after[p], v) for p, v in acting.items())  # it only acts
    want, got = dv3._leaves({k: params[k] for k in ft.DV3_TREES}), dv3._leaves(trees)
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    moments_got = dv3._adam_moments(agent[:4], optimizers)
    for name in ("world_model", "actor", "critic"):
        adam_state = opt_states[name][1][0]
        for slot, tree in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu)):
            w, g = dv3._leaves(tree), dv3._leaves(moments_got[name][slot])
            scale = max(float(np.abs(v).max()) for v in w.values())
            for path in w:
                np.testing.assert_allclose(g[path], w[path], atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")
    _check_moments(state, moments)


FAMILIES = {"dreamer_v3_jepa": _jepa, "p2e_dv3_exploration": _p2e_exploration,
            "p2e_dv3_finetuning": _p2e_finetuning}


@pytest.fixture(scope="module")
def built():
    """Each family's setup (its JAX agent built once, its two-device step
    compiled at its first call), made at its first use."""
    made = {}

    def get(name, make):
        if name not in made:
            made[name] = make()
        return made[name]

    return get


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_shard_steps_match_the_jax_step_on_two_devices(family, built, monkeypatch):
    assert len(jax.devices()) >= 2
    dv3._record_margins(monkeypatch)
    monkeypatch.setattr(jax, "jit", _jit_once(jax.jit))
    FAMILIES[family](built)
