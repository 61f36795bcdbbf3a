"""The port's DreamerV3-JEPA against the JAX package's, on the CPU at the
width of the JAX package's own JEPA test (``tests/test_algos/test_algos.py``:
8-unit layers, projector and predictor of 8, no decoder): the two views,
projector, predictor and loss; two consecutive gradient steps from
converted params and the JAX step's own noise, through the sequential scan
(with the health stats per module) and the chunked one (``rssm_chunks=2``,
a burn-in step); the converter on all five trees
and the world-model optimizer's optax state; checkpoints across the two
packages' loops; ``skip_update``; ``run``, ``eval`` and ``serve``.

Tolerances: views 1e-6 (the same draw added in fp32); forward outputs and
the loss 1e-5; the steps as DreamerV3's (``test_torch_dv3_train.py``:
metrics 1e-4, parameters 2e-6 absolute, Adam's moments 1e-4 of each tree's
scale), the EMA targets held like the parameters; converter round trips
exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.algos.dreamer_v3_jepa import dreamer_v3_jepa as jax_jepa
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.models import jepa as jax_jepa_models
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, load_learner_state, make_optimizers
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state
from sheeprl_tpu_torch.algos.dreamer_v3_jepa.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3_jepa.dreamer_v3_jepa import make_train_step
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.diagnostics.sentinel import poison_tree
from sheeprl_tpu_torch.interop.flax_params import optax_state, optimizer_state_dict
from sheeprl_tpu_torch.models.jepa import jepa_loss, make_two_views
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_dv3_train import (
    DISCRETE,
    GYM_OBS,
    OBS_SPACE,
    STOCH,
    TINY as DV3_TINY,
    B,
    H,
    T,
    _batch,
    _jit_build,
    _leaves,
    _record_margins,
    _t,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["exp=dreamer_v3_jepa"] + DV3_TINY[1:] + ["algo.cnn_keys.decoder=[]", "algo.mlp_keys.decoder=[]",
                                                  "algo.jepa_proj_dim=8", "algo.jepa_hidden=8",
                                                  "env.id=multidiscrete_dummy"]
ACTIONS_DIM = (2, 2)
TREES = ("world_model", "actor", "critic", "target_critic", "jepa")


class _Setup:
    """The JAX JEPA agent (built through its loop's ``_build_agent``, which
    fills the step's ``_HEADS``), every leaf perturbed (so the targets
    differ from the online modules), and its config in both packages."""

    def __init__(self, overrides=TINY):
        self.jax_cfg, self.cfg = jax_compose(list(overrides)), compose(list(overrides))
        self.actions_dim, self.is_continuous = ACTIONS_DIM, False

        def build():
            wm_def, actor_def, critic_def, params = jax_jepa._build_agent(None, ACTIONS_DIM, False, self.jax_cfg,
                                                                          GYM_OBS, None)
            return params, wm_def, actor_def, critic_def

        params, self.wm_def, self.actor_def, self.critic_def = _jit_build(build)
        self.heads = (jax_jepa._HEADS["projector_def"], jax_jepa._HEADS["predictor_def"])
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params)

    def agent(self, cfg=None):
        return build_agent(ACTIONS_DIM, False, cfg or self.cfg, OBS_SPACE, self.params, "cpu")


@pytest.fixture(scope="module")
def jepa():
    return _Setup()


def _view_noise(key, obs, dtype=jnp.float32):
    """The two draws ``make_two_views`` adds to each vector key, from
    ``key``: ``fold_in(key, i)`` over the sorted keys, then ``split``."""
    out = {}
    for i, k in enumerate(sorted(obs)):
        if obs[k].ndim != 5:
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            out[k] = (jax.random.normal(k1, obs[k].shape, dtype), jax.random.normal(k2, obs[k].shape, dtype))
    return out


def _obs(seed):
    rng = np.random.default_rng(seed)
    return {"rgb": (rng.integers(0, 256, (T, B, 3, 16, 16)) / 255.0 - 0.5).astype(np.float32),
            "state": rng.normal(size=(T, B, 10)).astype(np.float32)}


def test_views_projector_predictor_and_loss_match_jax(jepa):
    obs = _obs(1)
    key = jax.random.PRNGKey(3)
    want_q, want_k = jax.jit(lambda o, k: jax_jepa_models.make_two_views(o, k, 0.6, 0.2))(obs, key)
    noise = jax.tree_util.tree_map(_t, jax.jit(_view_noise)(key, obs))
    got_q, got_k = make_two_views({k: _t(v) for k, v in obs.items()}, 0.6, 0.2, noise=noise)
    for got, want in ((got_q, want_q), (got_k, want_k)):
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["rgb"].numpy(), np.asarray(want["rgb"]))  # the same mask
        np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]), atol=1e-6, rtol=0)
    assert not np.array_equal(got_q["state"].numpy(), got_k["state"].numpy())  # two draws

    agent = jepa.agent()
    params, (proj_def, pred_def) = jepa.params, jepa.heads
    rng = np.random.default_rng(2)
    z3 = rng.normal(size=(T, B, agent.jepa.projector.dense_0.in_features)).astype(np.float32)
    p2 = rng.normal(size=(B, 8)).astype(np.float32)
    with torch.no_grad():
        for tree, module in (("projector", agent.jepa.projector), ("target_projector", agent.jepa.target_projector)):
            want = jax.jit(proj_def.apply)(params["jepa"][tree], z3)  # [T, B, E]: mean-pooled over T
            np.testing.assert_allclose(module(_t(z3)).numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(module(_t(z3[0])).numpy(), np.asarray(jax.jit(proj_def.apply)(
                params["jepa"][tree], z3[0])), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(agent.jepa.predictor(_t(p2)).numpy(),
                                   np.asarray(jax.jit(pred_def.apply)(params["jepa"]["predictor"], p2)),
                                   atol=1e-5, rtol=1e-5)

    def jax_loss(p, oq, ok):
        return jax_jepa_models.jepa_loss(
            lambda o: jepa.wm_def.apply(p["world_model"], o, method="encode"),
            lambda o: jepa.wm_def.apply(p["jepa"]["target_encoder"], o, method="encode"),
            proj_def, pred_def, p["jepa"]["projector"], p["jepa"]["predictor"], p["jepa"]["target_projector"], oq, ok)

    want = jax.jit(jax_loss)(params, want_q, want_k)
    with torch.no_grad():
        got = jepa_loss(agent.world_model.encode, agent.jepa.target_encoder.encode, agent.jepa.projector,
                        agent.jepa.predictor, agent.jepa.target_projector, got_q, got_k)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    # the target branch carries no graph
    agent.jepa.projector.requires_grad_(True)
    loss = jepa_loss(agent.world_model.encode, agent.jepa.target_encoder.encode, agent.jepa.projector,
                     agent.jepa.predictor, agent.jepa.target_projector, got_q, got_k)
    loss.backward()
    assert agent.jepa.projector.dense_0.weight.grad is not None
    assert all(p.grad is None for p in agent.jepa.target_projector.parameters())
    assert all(p.grad is None for p in agent.jepa.target_encoder.parameters())


def _step_noise(key, chunks: int = 1, burn_in: int = 0):
    """The draws of the JAX JEPA step from ``key`` (its split is
    ``k_wm, k_img, k_img_actions, k_views``), as port noise; with
    ``chunks > 1`` the chunked scan's (``split(k_wm)`` into the main steps'
    keys, unfolded to ``[T, B, ...]``, and the burn-in steps')."""
    K, C = chunks, T // chunks

    def pair(keys, rows):
        p = [jax.random.split(k) for k in keys]
        return (jnp.stack([jax.random.gumbel(k[0], (rows, STOCH, DISCRETE)) for k in p]),
                jnp.stack([jax.random.gumbel(k[1], (rows, STOCH, DISCRETE)) for k in p]))

    def draw(key, obs):
        k_wm, k_img, k_img_actions, k_views = jax.random.split(key, 4)

        def actor_noise(k):
            return [jax.random.gumbel(jax.random.fold_in(k, i), (T * B, d)) for i, d in enumerate(ACTIONS_DIM)]

        img = [jax.random.split(k) for k in jax.random.split(k_img, H)]
        noise = {
            "imagination": jnp.stack([jax.random.gumbel(k[0], (T * B, STOCH, DISCRETE)) for k in img]),
            "actor": [actor_noise(k_img_actions)] + [actor_noise(k[1]) for k in img],
            "views": _view_noise(k_views, obs),
        }
        if chunks == 1:
            noise["dynamic"] = pair(jax.random.split(k_wm, T), B)
            return noise
        k_main, k_burn = jax.random.split(k_wm)
        noise["dynamic"] = tuple(y.reshape(C, K, B, STOCH, DISCRETE).swapaxes(0, 1).reshape(T, B, STOCH, DISCRETE)
                                 for y in pair(jax.random.split(k_main, C), K * B))
        if burn_in:
            noise["burn_in"] = pair(jax.random.split(k_burn, burn_in), (K - 1) * B)
        return noise

    shapes = {"rgb": jnp.zeros((T, B, 3, 16, 16)), "state": jnp.zeros((T, B, 10))}
    return jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), jax.jit(draw)(key, shapes))


def _jax_optimizers(setup, params):
    """The JAX loop's optimizers and their state: the world model's over
    ``(world_model, {projector, predictor})`` (``_extra_opt_setup``)."""
    cfg = setup.jax_cfg
    opts = {k: optax.chain(optax.clip_by_global_norm(cfg.algo[k].clip_gradients),
                           jax_instantiate(cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    opt_states = {k: opts[k].init(params[k]) for k in opts}
    return opts, jax_jepa._extra_opt_setup(opts, opt_states, params)


def _adam_state_leaves(optimizers, agent) -> dict:
    """Each optimizer's optax state as the port writes it, by path."""
    return {name: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(
        optax_state(opt, agent.optimizer_spec(name))[1][0].fields[1:])} for name, opt in optimizers.items()}


def _jl(metrics, cfg):
    """The JEPA loss inside the JAX step's world-model loss: ``rec_loss +
    jepa_coef * jl`` less the reconstruction terms it reports."""
    m = np.asarray(metrics, np.float64)
    rec = cfg.algo.world_model.kl_regularizer * m[3] + m[1] + m[2] + m[4]
    return (m[0] - rec) / cfg.algo.jepa_coef


def _stored_states(seed):
    """The chunked scan's stored states: one-hot posteriors, tanh
    recurrents, one row of each column invalid."""
    rng = np.random.default_rng(seed)
    valid = np.ones((T, B, 1), np.float32)
    valid[1, 0] = valid[0, 1] = 0.0
    return {"rssm_posterior": np.eye(DISCRETE, dtype=np.float32)[rng.integers(0, DISCRETE, (T, B, STOCH))].reshape(
                T, B, STOCH * DISCRETE),
            "rssm_recurrent": np.tanh(rng.normal(size=(T, B, 8))).astype(np.float32), "rssm_valid": valid}


@pytest.mark.parametrize("scan", ["sequential", "chunked"])
def test_two_train_steps_match_make_train_step(scan, monkeypatch):
    """Two fp32 gradient steps from one set of converted params and the JAX
    step's noise: the metrics (``Loss/jepa_loss`` against the JAX step's
    world-model loss less its reconstruction terms), all five trees (the
    targets moved by the EMA), the world-model optimizer's state over the
    tuple.  ``sequential``: the default diagnostics' health stats, per
    module (``jepa`` their own); ``chunked``: ``algo.rssm_chunks=2`` with a
    burn-in step, on stored states."""
    chunked = scan == "chunked"
    if chunked:
        setup = _Setup(TINY + ["algo.rssm_chunks=2", "algo.rssm_chunk_burn_in=1"])
    else:
        setup = _Setup([o for o in TINY if o != "diagnostics=off"] + ["diagnostics.health.per_module=True"])
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opts, opt_states = _jax_optimizers(setup, params)
    jax_step = jax_jepa.make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, opts, setup.jax_cfg,
                                        ACTIONS_DIM, False)
    moments = jax_dv3_utils.init_moments_state()
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, False)
    assert step.metric_order == METRIC_ORDER + ["Loss/jepa_loss"]
    state = init_moments_state()
    _record_margins(monkeypatch)
    batch = {k: v.astype(np.float32) for k, v in _batch(setup, 11).items()}
    if chunked:
        batch.update(_stored_states(12))
    key = jax.random.PRNGKey(5)
    n = len(METRIC_ORDER)
    for i, tau in enumerate((1.0, 0.02)):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics, jax_health = jax_step(
            params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, sub, jnp.float32(tau))
        noise = _step_noise(sub, 2, 1) if chunked else _step_noise(sub)
        state, metrics = step(state, {k: _t(v) for k, v in batch.items()}, tau, None, noise)
        got, want = metrics.numpy(), np.asarray(jax_metrics)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:n], want, atol=1e-4, rtol=1e-4, err_msg=f"step {i}: {METRIC_ORDER}")
        np.testing.assert_allclose(got[n], _jl(want, setup.cfg), atol=1e-4, rtol=1e-4)
        if not chunked:
            health = dict(zip(step.health_names, got[n + 1:]))
            assert sorted(health) == sorted(jax_health) and "module/jepa/update_ratio" in health
            for k, v in jax_health.items():
                if k.endswith("dead_frac"):
                    assert health[k] == float(v), k
                else:
                    np.testing.assert_allclose(health[k], float(v), rtol=1e-4, atol=1e-4 * max(1.0, abs(float(v))),
                                               err_msg=k)

    want_trees, got_trees = _leaves({k: params[k] for k in TREES}), _leaves(agent.trees())
    assert sorted(got_trees) == sorted(want_trees) and any("target_encoder" in p for p in want_trees)
    for path, value in want_trees.items():
        np.testing.assert_allclose(got_trees[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    ours = _adam_state_leaves(optimizers, agent)
    for name in ("world_model", "actor", "critic"):
        adam = opt_states[name][1][0]
        want = {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path((adam.mu, adam.nu))}
        assert sorted(want) == sorted(ours[name])
        scale = max(float(np.abs(v).max()) for v in want.values())
        for path, value in want.items():
            np.testing.assert_allclose(ours[name][path], value, atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")
    np.testing.assert_allclose(state["low"].numpy(), np.asarray(moments["low"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state["high"].numpy(), np.asarray(moments["high"]), atol=1e-5, rtol=1e-5)


def test_the_targets_move_by_exactly_the_moving_average_of_the_new_online_weights(jepa):
    agent = jepa.agent()
    optimizers = make_optimizers(jepa.cfg, agent)
    step = make_train_step(agent, optimizers, jepa.cfg, False)
    ema = float(jepa.cfg.algo.jepa_ema)
    targets = {k: v.clone() for k, v in agent.jepa.state_dict().items() if k.startswith("target_")}
    step(init_moments_state(), {k: _t(v.astype(np.float32)) for k, v in _batch(jepa, 4).items()}, 1.0,
         torch.Generator().manual_seed(0))
    online = {**{f"target_encoder.{k}": v for k, v in agent.world_model.state_dict().items()
                 if k.startswith(("cnn_encoder.", "mlp_encoder."))},
              **{f"target_projector.{k}": v for k, v in agent.jepa.projector.state_dict().items()}}
    assert sorted(online) == sorted(targets)
    now = agent.jepa.state_dict()
    for k, old in targets.items():
        assert torch.equal(now[k], old * ema + online[k] * (1.0 - ema)), k


def test_converter_round_trips_all_five_trees_and_the_world_model_optax_state(jepa, tmp_path):
    """Every leaf of the five trees back exactly; the world-model optimizer's
    optax state (the JAX loop's tuple ``(world_model, {projector,
    predictor})``, random moments) into the port's Adam and back exactly."""
    from sheeprl_tpu.utils.checkpoint import save_state as jax_save_state

    agent = jepa.agent()
    back, want = _leaves(agent.trees()), _leaves(jepa.params)
    assert sorted(back) == sorted(want)
    for path, value in want.items():
        assert np.array_equal(back[path], value), path

    params = jax.tree_util.tree_map(jnp.asarray, jepa.params)
    _, opt_states = _jax_optimizers(jepa, params)
    rng = np.random.default_rng(9)
    saved = jax.tree_util.tree_map(lambda a: np.asarray(a) if np.asarray(a).dtype == np.int32 else
                                   rng.random(np.shape(a)).astype(np.float32), opt_states["world_model"])
    saved = (saved[0], (saved[1][0]._replace(count=np.asarray(3, np.int32)), saved[1][1]))
    jax_save_state(str(tmp_path / "opt.ckpt"), {"opt": saved})
    saved = load_state(str(tmp_path / "opt.ckpt"))["opt"]
    optimizers = make_optimizers(jepa.cfg, agent)
    opt = optimizers["world_model"]
    opt.load_state_dict(optimizer_state_dict(saved, opt, agent.optimizer_spec("world_model")))
    assert len(opt.state) == len(agent.parameters_of("world_model"))
    ours = optax_state(opt, agent.optimizer_spec("world_model"))
    assert isinstance(ours[1][0].fields[1], tuple) and sorted(ours[1][0].fields[1][1]) == ["predictor", "projector"]
    assert int(ours[1][0].fields[0]) == 3
    for slot in (1, 2):
        w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tuple(saved[1][0])[slot])}
        g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(ours[1][0].fields[slot])}
        assert sorted(w) == sorted(g)
        for path in w:
            assert np.array_equal(np.asarray(w[path]), g[path]), path


def test_skip_update_leaves_the_heads_and_targets_bit_identical():
    setup_cfg = compose(TINY + ["diagnostics.enabled=True", "diagnostics.sentinel.enabled=True",
                                "diagnostics.sentinel.policy=skip_update"])
    agent = build_agent(ACTIONS_DIM, False, setup_cfg, OBS_SPACE, None, "cpu")
    optimizers = make_optimizers(setup_cfg, agent)
    step = make_train_step(agent, optimizers, setup_cfg, False)

    class _S:
        is_continuous = False

    batch = {k: _t(v.astype(np.float32)) for k, v in _batch(_S, 3).items()}
    gen = torch.Generator().manual_seed(1)
    moments, _ = step(init_moments_state(), batch, 1.0, gen)

    def snapshot():
        out = {f"{name}.{k}": v.clone() for name in TREES for k, v in getattr(agent, name).state_dict().items()}
        for name, opt in optimizers.items():
            for i, s in enumerate(opt.state.values()):
                out.update({f"opt.{name}.{i}.{k}": v.clone() for k, v in s.items()})
        return out

    before = snapshot()
    moments, metrics = step(moments, poison_tree(batch), 0.02, gen)
    assert not torch.isfinite(metrics[:len(step.metric_order)]).all()  # (no decoder: the observation loss is 0)
    after = snapshot()
    assert any(k.startswith("jepa.target_encoder") for k in after)
    for key, value in before.items():
        assert torch.equal(after[key], value), key
    moments, metrics = step(moments, batch, 0.02, gen)
    assert torch.isfinite(metrics).all()
    assert not torch.equal(agent.jepa.target_projector.dense_0.weight, before["jepa.target_projector.dense_0.weight"])


# learning from iteration 4 of 16 (2 envs), a checkpoint every 4 iterations
# with the replay buffer: a run resumed from the first trains again from
# iteration 4 + 5, as the JAX loop waits learning_starts again
RUN = TINY + ["fabric.accelerator=cpu", "algo.learning_starts=8", "algo.total_steps=32", "buffer.size=64",
              "env.num_envs=2", "metric.log_every=8", "metric.logger=null", "checkpoint.every=8",
              "checkpoint.save_last=True", "buffer.checkpoint=True"]


def _one_step_each(ckpt, setup, jax_steps):
    """One step of each package from one checkpoint, restored as each
    loop restores it (the JAX loop: its ``_build_agent`` on the state, the
    optax states onto ``_extra_opt_setup``'s): metrics 1e-4, the five trees
    2e-6."""
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    jax_state, state = jax_load_state(ckpt), load_state(ckpt)
    params = jax.tree_util.tree_map(jnp.asarray, _jit_build(lambda: (jax_jepa._build_agent(
        None, ACTIONS_DIM, False, setup.jax_cfg, GYM_OBS, jax_state)[3],))[0])
    assert sorted(params) == sorted(TREES)
    opts, init = _jax_optimizers(setup, params)
    opt_states = {k: jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=ref.dtype), init[k],
                                            jax_state["opt_states"][k]) for k in init}
    moments = jax.tree_util.tree_map(jnp.asarray, jax_state["moments"])
    if not jax_steps:  # one compiled step for every checkpoint
        jax_steps.append(jax_jepa.make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, opts,
                                                  setup.jax_cfg, ACTIONS_DIM, False))
    jax_step = jax_steps[0]
    agent = build_agent(ACTIONS_DIM, False, setup.cfg, OBS_SPACE, state, "cpu")
    optimizers = make_optimizers(setup.cfg, agent)
    moments_state = load_learner_state(state, agent, optimizers, "cpu")
    step = make_train_step(agent, optimizers, setup.cfg, False)
    batch = {k: v.astype(np.float32) for k, v in _batch(setup, 17).items()}
    key = jax.random.PRNGKey(33)
    params, _, _, jax_metrics = jax_step(params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()},
                                         key, jnp.float32(0.02))[:4]
    _, metrics = step(moments_state, {k: _t(v) for k, v in batch.items()}, 0.02, None, _step_noise(key))
    np.testing.assert_allclose(metrics[:len(METRIC_ORDER)].numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4)
    want, got = _leaves({k: params[k] for k in TREES}), _leaves(agent.trees())
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)


def test_checkpoints_cross_between_the_two_packages_loops(jepa, tmp_path, monkeypatch):
    """The JAX loop writes a checkpoint; the port's ``run`` resumes it and
    trains on, and writes its own, which the JAX ``verify_checkpoint``
    accepts; from each, restored as each loop restores it, one step of each
    package agrees."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint

    monkeypatch.chdir(tmp_path)

    def steps(root):
        return sorted(int(p.name.split("_")[1]) for p in (tmp_path / "logs").rglob("*.ckpt") if root in str(p))

    jax_run(RUN + ["root_dir=jax_jepa", "algo.run_test=False"])  # its test episode is not read
    jax_ckpt = next(p for p in (tmp_path / "logs").rglob("ckpt_8_0.ckpt") if "jax_jepa" in str(p))
    assert steps("jax_jepa") == [8, 16, 24, 32] and "jepa" in load_state(str(jax_ckpt))
    jax_steps = []
    _one_step_each(str(jax_ckpt), jepa, jax_steps)

    out = cli.run([o for o in RUN if o != "diagnostics=off"] + [f"checkpoint.resume_from={jax_ckpt}"])
    assert out["start_iter"] == 5 and out["policy_steps"] == 32 and out["gradient_steps"] > 0
    assert out["metric_rows"].shape[1] == len(METRIC_ORDER) + 1 and np.isfinite(out["metric_rows"]).all()
    port_ckpt = out["checkpoints"][0]
    assert port_ckpt.endswith("ckpt_16_0.ckpt") and jax_verify_checkpoint(port_ckpt) == (True, "verified")
    _one_step_each(port_ckpt, jepa, jax_steps)
    assert [int(c.rsplit("ckpt_", 1)[1].split("_")[0]) for c in out["checkpoints"]] == [16, 24, 32]


def test_run_on_the_cpu_logs_the_jepa_loss_evaluates_and_serve_refuses_it(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = cli.run(RUN + ["checkpoint.every=100"])
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    assert any("Loss/jepa_loss" in m for m in out["logged"])
    ckpt = out["checkpoints"][-1]
    assert {"world_model", "actor", "critic", "target_critic", "jepa", "opt_states", "moments"} <= set(
        load_state(ckpt))
    reward = cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert np.isfinite(reward)
    cfg, path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    from sheeprl_tpu_torch.serving.loader import load_policy

    with pytest.raises(ValueError, match="no servable adapter"):
        load_policy(cfg, path, device)


def test_a_tiny_run_of_the_xs_preset(tmp_path, monkeypatch):
    """``exp=dreamer_v3_jepa_xs`` at its own widths (recurrent 256, dense 256,
    CNN multiplier 24, one layer, 64x64 pixels), cut in depth."""
    monkeypatch.chdir(tmp_path)
    cfg = compose(["exp=dreamer_v3_jepa_xs", "env=dummy"])
    wm = cfg.algo.world_model
    assert (wm.recurrent_model.recurrent_state_size, cfg.algo.dense_units, wm.encoder.cnn_channels_multiplier,
            cfg.algo.mlp_layers) == (256, 256, 24, 1)
    out = cli.run(["exp=dreamer_v3_jepa_xs", "env=dummy", "fabric.accelerator=cpu", "algo.per_rank_batch_size=2",
                   "algo.per_rank_sequence_length=4", "algo.horizon=2", "algo.learning_starts=8",
                   "algo.total_steps=12", "buffer.size=32", "env.num_envs=2", "metric.logger=null",
                   "checkpoint.every=100", "checkpoint.save_last=False", "algo.run_test=False", "diagnostics=off"])
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
