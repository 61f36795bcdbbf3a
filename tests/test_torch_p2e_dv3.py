"""The port's Plan2Explore-DV3 against the JAX package's, on the CPU at the
JAX package's P2E test widths (``tests/test_algos/test_algos.py``'s
``P2E_TINY``: 8-unit layers, one layer, an ensemble of 3 x 8 x 1) on the
tiny latent and 16-pixel screen of ``test_torch_dv3_train.py``: the
stacked ensemble against the JAX vmapped one; the exploration critics'
spec; the converter on all seven trees, the six kinds of optax state and
the Moments tree; two consecutive exploration gradient steps against the
JAX ``make_train_step`` for discrete and continuous actions; finetuning's
config surgery, its state mapping and the player's switch; checkpoints
across the two packages' loops; ``run``'s refusals, ``eval`` and
``serve``'s refusal.

Random draws go through injected noise taken from the JAX keys with the
JAX step's own splits (``k_wm, k_img_e, k_a0_e, k_img_t, k_a0_t``, then one
split a step into dynamics and actor).  Tolerances: the ensemble 1e-5; the
steps as DreamerV3's (metrics 1e-4, parameters 2e-6 absolute, Adam's
moments 1e-4 of each tree's scale, Moments 1e-5); converter round trips
exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_dv3_make_train_step
from sheeprl_tpu.algos.p2e_dv3 import agent as jax_p2e_agent
from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_exploration as jax_ex
from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_finetuning as jax_ft
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    METRIC_ORDER,
    load_learner_state,
    make_optimizers,
    make_train_step as make_dv3_train_step,
    nest,
)
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning as ft
from sheeprl_tpu_torch.algos.p2e_dv3.agent import TREES, build_agent, exploration_critics_spec
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_train_step, metric_order
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.interop.flax_params import optax_state
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
    _jax_noise,
    _jit_build,
    _leaves,
    _record_margins,
    _t,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["exp=p2e_dv3_exploration"] + DV3_TINY[1:] + [
    "algo.mlp_layers=1", "algo.ensembles.n=3", "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1",
    "algo.cnn_keys.decoder=[rgb]", "algo.mlp_keys.decoder=[state]"]
FAMILIES = {"discrete": ("discrete_dummy", (2,), False, ()),
            # vector observations only, as DreamerV3's continuous parity case
            "continuous": ("continuous_dummy", (2,), True, ("algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]"))}


class _Setup:
    """The JAX P2E agent (through its loop's ``_build_agent``, which fills
    the step's ``_P2E``), every leaf perturbed, its config in both packages,
    and its step, compiled once."""

    def __init__(self, family: str):
        env_id, self.actions_dim, self.is_continuous, extra = FAMILIES[family]
        overrides = TINY + [f"env.id={env_id}", *extra]
        self.jax_cfg, self.cfg = jax_compose(overrides), compose(overrides)

        def build():
            wm_def, actor_def, critic_def, params = jax_ex._build_agent(None, self.actions_dim, self.is_continuous,
                                                                        self.jax_cfg, GYM_OBS, None)
            return params, wm_def, actor_def, critic_def

        params, self.wm_def, self.actor_def, self.critic_def = _jit_build(build)
        self.ensemble_def, self.critics_spec = jax_ex._P2E["ensemble_def"], jax_ex._P2E["critics_spec"]
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params)
        self.optimizers, _ = jax_ex._make_optimizers(self.jax_cfg, self.params, None)
        self.step = jax_ex.make_train_step(self.wm_def, self.actor_def, self.critic_def, self.optimizers,
                                           self.jax_cfg, self.actions_dim, self.is_continuous)

    def agent(self, state=None):
        return build_agent(self.actions_dim, self.is_continuous, self.cfg, OBS_SPACE,
                           self.params if state is None else state, "cpu")

    def restore_jax(self, state):
        """A checkpoint restored as the JAX exploration loop restores it:
        its ``_build_agent`` on the state, ``_make_optimizers``,
        ``_init_moments``."""
        jax_ex._P2E.update(ensemble_def=self.ensemble_def, critics_spec=self.critics_spec)
        params = jax.tree_util.tree_map(jnp.asarray, _jit_build(lambda: (jax_ex._build_agent(
            None, self.actions_dim, self.is_continuous, self.jax_cfg, GYM_OBS, state)[3],))[0])
        _, opt_states = jax_ex._make_optimizers(self.jax_cfg, params, state)
        return params, opt_states, jax_ex._init_moments(self.jax_cfg, state)


@pytest.fixture(scope="module")
def setups():
    return {}


def _setup(setups, family):
    if family not in setups:
        setups[family] = _Setup(family)
    return setups[family]


def _noise(setup, key):
    """The draws of the JAX P2E step from ``key``, as port noise."""

    def actor_noise(k):
        if setup.is_continuous:
            return [jax.random.normal(k, (T * B, sum(setup.actions_dim)))]
        return [jax.random.gumbel(jax.random.fold_in(k, i), (T * B, d)) for i, d in enumerate(setup.actions_dim)]

    def imagination(k_img, k_a0):
        img = [jax.random.split(k) for k in jax.random.split(k_img, H)]
        return {"imagination": jnp.stack([jax.random.gumbel(k[0], (T * B, STOCH, DISCRETE)) for k in img]),
                "actor": [actor_noise(k_a0)] + [actor_noise(k[1]) for k in img]}

    def draw(key):
        k_wm, k_img_e, k_a0_e, k_img_t, k_a0_t = jax.random.split(key, 5)
        pairs = [jax.random.split(k) for k in jax.random.split(k_wm, T)]
        return {"dynamic": (jnp.stack([jax.random.gumbel(p[0], (B, STOCH, DISCRETE)) for p in pairs]),
                            jnp.stack([jax.random.gumbel(p[1], (B, STOCH, DISCRETE)) for p in pairs])),
                "exploration": imagination(k_img_e, k_a0_e), "task": imagination(k_img_t, k_a0_t)}

    return jax.tree_util.tree_map(_t, jax.jit(draw)(key))


def _p2e_batch(setup, seed: int) -> dict:
    """DreamerV3's test batch, with the discrete dummy's one two-way action."""
    batch = {k: v.astype(np.float32) for k, v in _batch(setup, seed).items()}
    if not setup.is_continuous:
        batch["actions"] = np.eye(2, dtype=np.float32)[np.random.default_rng(seed).integers(0, 2, (T, B))]
    return batch


def _moments_tree(moments):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), moments)


def _opt_leaves(opt_states) -> dict:
    """``{optimizer name: {path: array}}`` of the Adam ``mu``/``nu`` of an
    optax state tree (the JAX step's, or the port's as it writes it)."""
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}/{k}" if name else k)
            return
        adam = node[1][0]
        mu, nu = (adam.mu, adam.nu) if hasattr(adam, "mu") else (adam.fields[1], adam.fields[2])
        out[name] = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path((mu, nu))}

    walk(opt_states, "")
    return out


def _port_opt_states(agent, optimizers):
    return nest({name: optax_state(opt, agent.optimizer_spec(name)) for name, opt in optimizers.items()})


def _assert_step_state(setup, params, opt_states, moments, agent, optimizers, state, adam: bool = True):
    """The seven trees, the Adam moments of every optimizer (with ``adam``)
    and the Moments tree of the two packages after their steps."""
    want, got = _leaves({k: params[k] for k in TREES}), _leaves(agent.trees())
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    want, got = _opt_leaves(opt_states), _opt_leaves(_port_opt_states(agent, optimizers))
    assert sorted(want) == sorted(got) and "critics_exploration/intrinsic" in want
    for name, leaves in (want.items() if adam else ()):
        assert sorted(leaves) == sorted(got[name])
        scale = max(float(np.abs(v).max()) for v in leaves.values())
        for path, value in leaves.items():
            np.testing.assert_allclose(got[name][path], value, atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")
    want, got = _leaves(_moments_tree(moments)), _leaves(_moments_tree(jax.tree_util.tree_map(
        lambda t: t.numpy(), state)))
    assert sorted(want) == sorted(got) and len(want) == 2 * (1 + len(setup.critics_spec))
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=1e-5, rtol=1e-5, err_msg=f"moments{path}")


def test_ensemble_forward_matches_the_jax_vmapped_ensemble(setups):
    setup = _setup(setups, "discrete")
    agent = setup.agent()
    x = np.random.default_rng(3).normal(size=(T, B, agent.ensembles.kernels[0].shape[1])).astype(np.float32)
    want = jax.jit(lambda p, x: jax.vmap(lambda q: setup.ensemble_def.apply(q, x))(p))(setup.params["ensembles"], x)
    with torch.no_grad():
        got = agent.ensembles(_t(x))
    assert got.shape == want.shape == (3, T, B, STOCH * DISCRETE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # one product a layer over all members: a member alone is its own MLP
    with torch.no_grad():
        ens = agent.ensembles
        h = torch.nn.functional.silu(torch.nn.functional.layer_norm(
            _t(x) @ ens.kernels[0][1], (8,), ens.scales[0][1], ens.biases[0][1], eps=ens.eps))
        np.testing.assert_allclose((h @ ens.out_kernel[1] + ens.out_bias[1]).numpy(), got[1].numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_exploration_critics_spec_is_sorted_positive_and_needs_an_intrinsic_critic():
    cfg, jax_cfg = compose(TINY), jax_compose(TINY)
    assert exploration_critics_spec(cfg) == jax_p2e_agent.exploration_critics_spec(jax_cfg) == [
        ("extrinsic", 1.0, "task"), ("intrinsic", 0.1, "intrinsic")]
    only = TINY + ["algo.critics_exploration.extrinsic.weight=0"]
    assert exploration_critics_spec(compose(only)) == jax_p2e_agent.exploration_critics_spec(jax_compose(only)) == [
        ("intrinsic", 0.1, "intrinsic")]
    overrides = TINY + ["algo.critics_exploration.intrinsic.weight=0"]
    for spec_of, c in ((exploration_critics_spec, compose(overrides)),
                       (jax_p2e_agent.exploration_critics_spec, jax_compose(overrides))):
        with pytest.raises(RuntimeError, match="at least one intrinsic critic"):
            spec_of(c)
    assert metric_order(exploration_critics_spec(cfg)) == jax_ex.metric_order(
        jax_p2e_agent.exploration_critics_spec(jax_cfg))


def test_converter_round_trips_the_seven_trees_the_optax_states_and_the_moments(setups, tmp_path):
    """Every leaf of the seven trees back exactly; the six kinds of optax
    state (one per exploration critic) and the Moments tree, random values
    written by the JAX package, into the port's optimizers and back
    exactly."""
    from sheeprl_tpu.utils.checkpoint import save_state as jax_save_state

    setup = _setup(setups, "discrete")
    agent = setup.agent()
    back, want = _leaves(agent.trees()), _leaves(setup.params)
    assert sorted(back) == sorted(want) and any("critics_exploration" in p for p in want)
    for path, value in want.items():
        assert np.array_equal(back[path], value), path

    _, opt_states = jax_ex._make_optimizers(setup.jax_cfg, setup.params, None)
    rng = np.random.default_rng(9)
    saved = jax.tree_util.tree_map(lambda a: np.asarray(3, np.int32) if np.asarray(a).dtype == np.int32 else
                                   rng.random(np.shape(a)).astype(np.float32), opt_states)
    moments = jax.tree_util.tree_map(lambda a: np.float32(rng.random()), jax_ex._init_moments(setup.jax_cfg, None))
    jax_save_state(str(tmp_path / "opt.ckpt"), {"opt_states": saved, "moments": moments})
    state = load_state(str(tmp_path / "opt.ckpt"))
    optimizers = make_optimizers(setup.cfg, agent)
    assert sorted(optimizers) == sorted(["world_model", "actor_task", "critic_task", "actor_exploration", "ensembles",
                                         "critics_exploration/extrinsic", "critics_exploration/intrinsic"])
    restored = load_learner_state(state, agent, optimizers, "cpu")
    ours = _port_opt_states(agent, optimizers)
    assert sorted(ours) == sorted(saved) and sorted(ours["critics_exploration"]) == ["extrinsic", "intrinsic"]
    want, got = _opt_leaves(saved), _opt_leaves(ours)
    assert sorted(want) == sorted(got)
    for name in want:
        for path, value in want[name].items():
            assert np.array_equal(got[name][path], value), f"{name}{path}"
    assert all(int(node[1][0].fields[0]) == 3 for node in (ours["world_model"], ours["critics_exploration"]["intrinsic"]))
    got_m = _leaves(jax.tree_util.tree_map(lambda t: t.numpy(), restored))
    for path, value in _leaves(moments).items():
        assert got_m[path] == value, path
    with pytest.raises(KeyError, match="moments"):
        load_learner_state({**state, "moments": moments["task"]}, agent, optimizers, "cpu")


@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_two_exploration_steps_match_make_train_step(family, setups, monkeypatch):
    """Two fp32 exploration steps from one set of converted params and the
    JAX step's noise: the metric vector, all seven trees, the Adam moments
    of every optimizer and the Moments tree."""
    setup = _setup(setups, family)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    _, opt_states = jax_ex._make_optimizers(setup.jax_cfg, params, None)
    moments = jax_ex._init_moments(setup.jax_cfg, None)
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, setup.is_continuous)
    assert step.metric_order == jax_ex.metric_order(setup.critics_spec) and step.health_names == []
    state = agent.initial_moments("cpu")
    _record_margins(monkeypatch)
    batch = _p2e_batch(setup, 11)
    key = jax.random.PRNGKey(5)
    for i, tau in enumerate((1.0, 0.02)):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics = setup.step(
            params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, sub, jnp.float32(tau))
        state, metrics = step(state, {k: _t(v) for k, v in batch.items()}, tau, None, _noise(setup, sub))
        got, want = metrics.numpy(), np.asarray(jax_metrics)
        assert np.isfinite(got).all() and got.shape == want.shape == (len(step.metric_order),)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=f"step {i}: {step.metric_order}")
    intrinsic = step.metric_order.index("Rewards/intrinsic_intrinsic")
    assert got[intrinsic] > 0  # the members disagree
    _assert_step_state(setup, params, opt_states, moments, agent, optimizers, state)


def test_finetuning_config_surgery_state_mapping_and_player_switch(setups, tmp_path):
    """The exploration run's fields copied and its env held; an exploration
    checkpoint's task trees, optimizer states and Moments mapped as the JAX
    finetuning restores them; the exploration actor until the first
    gradient step, the task actor after it."""
    setup = _setup(setups, "discrete")
    explored = compose(TINY + ["algo.horizon=5", "env.screen_size=32", "buffer.checkpoint=True", "env.num_envs=3"])
    cfg = compose(["exp=p2e_dv3_finetuning", "env=dummy", "buffer.load_from_exploration=True",
                   "checkpoint.exploration_ckpt_path=x"])
    ft.apply_exploration_cfg(cfg, explored)
    assert (cfg.algo.horizon, cfg.env.screen_size, cfg.env.num_envs, cfg.algo.world_model.discrete_size) == (
        5, 32, 3, DISCRETE)
    with pytest.raises(ValueError, match="exploration environment"):
        ft.apply_exploration_cfg(compose(["exp=p2e_dv3_finetuning", "env=dummy", "env.id=continuous_dummy",
                                          "checkpoint.exploration_ckpt_path=x"]), explored)

    # an exploration checkpoint, restored as each package's finetuning does
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    rng = np.random.default_rng(4)
    for opt in optimizers.values():
        for p in [p for g in opt.param_groups for p in g["params"]]:
            opt.state[p] = {"step": torch.tensor(2.0), "exp_avg": torch.from_numpy(rng.random(p.shape).astype(
                np.float32)), "exp_avg_sq": torch.from_numpy(rng.random(p.shape).astype(np.float32))}
    moments = jax.tree_util.tree_map(lambda _: torch.tensor(float(rng.random())), agent.initial_moments("cpu"))
    state = {**agent.trees(), "opt_states": _port_opt_states(agent, optimizers), "moments": moments}
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state
    from sheeprl_tpu_torch.utils.checkpoint import save_state

    save_state(str(tmp_path / "ckpt_1_0.ckpt"), state)
    jax_state, state = jax_load_state(str(tmp_path / "ckpt_1_0.ckpt")), load_state(str(tmp_path / "ckpt_1_0.ckpt"))
    dv3_cfg = compose([o.replace("exp=p2e_dv3_exploration", "exp=p2e_dv3_finetuning") for o in TINY]
                      + ["env.id=discrete_dummy", "checkpoint.exploration_ckpt_path=x"])
    mapped = ft.finetuning_state(state)
    port = ft.build_agent((2,), False, dv3_cfg, OBS_SPACE, mapped)
    port_opts = make_optimizers(dv3_cfg, port)
    port_moments = load_learner_state(mapped, port, port_opts, "cpu")
    jax_dv3_cfg = jax_compose([o.replace("exp=p2e_dv3_exploration", "exp=p2e_dv3_finetuning") for o in TINY]
                              + ["env.id=discrete_dummy", "checkpoint.exploration_ckpt_path=x"])
    jax_params = _jit_build(lambda: (jax_ft._build_agent(None, (2,), False, jax_dv3_cfg, GYM_OBS, jax_state)[3],))[0]
    _, jax_opts = jax_ft._make_optimizers(jax_dv3_cfg, jax_params, jax_state)
    jax_moments = jax_ft._init_moments(jax_dv3_cfg, jax_state)
    assert sorted(port.trees()) == sorted(jax_params) == sorted(ft.DV3_TREES + ("actor_exploration",))
    want, got = _leaves(jax_params), _leaves(port.trees())
    for path, value in want.items():
        assert np.array_equal(got[path], value), path
    want, got = _opt_leaves(jax_opts), _opt_leaves(_port_opt_states(port, port_opts))
    assert sorted(want) == sorted(got) == ["actor", "critic", "world_model"]
    for name in want:
        for path, value in want[name].items():
            assert np.array_equal(got[name][path], value), f"{name}{path}"
    assert {k: float(v) for k, v in port_moments.items()} == {k: float(v) for k, v in jax_moments.items()} == {
        k: float(v) for k, v in moments["task"].items()}

    # the player's actor, as the JAX finetuning's _player_actor picks it
    for actor_type in ("exploration", "task"):
        c = compose(["exp=p2e_dv3_finetuning", "env=dummy", f"algo.player.actor_type={actor_type}",
                     "checkpoint.exploration_ckpt_path=x"])
        pick = jax_ft._player_actor(c)
        names = {"actor": "actor", "actor_exploration": "actor_exploration"}
        for has_trained in (False, True):
            assert ft.player_actor(c)(has_trained) == names[pick(names, has_trained)]


# a tiny run of each loop: learning from policy step 8 (2 envs), a replay
# ratio that owes the first gradient step some iterations after the player
# starts, a checkpoint every 8 policy steps with the replay
RUN = TINY + ["env.id=discrete_dummy", "fabric.accelerator=cpu", "algo.learning_starts=8", "algo.total_steps=24",
              "algo.replay_ratio=0.3", "buffer.size=64", "env.num_envs=2", "metric.log_every=8", "metric.logger=null",
              "checkpoint.every=8", "checkpoint.save_last=True", "buffer.checkpoint=True"]


def _finetune_overrides(ckpt: str):
    return [o.replace("exp=p2e_dv3_exploration", "exp=p2e_dv3_finetuning") for o in RUN] + [
        f"checkpoint.exploration_ckpt_path={ckpt}", "buffer.load_from_exploration=True"]


def test_checkpoints_cross_between_the_two_packages_loops(setups, tmp_path, monkeypatch):
    """The JAX exploration loop writes a checkpoint: the port resumes its
    exploration from it (all six optimizer states and the Moments tree; one
    step of each package agrees) and finetunes from it.  The port's
    exploration checkpoint passes the JAX ``verify_checkpoint``; restored as
    the JAX finetuning restores it, one DreamerV3 step of each package
    agrees."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    monkeypatch.chdir(tmp_path)
    setup = _setup(setups, "discrete")
    jax_run(RUN + ["root_dir=jax_p2e", "algo.run_test=False"])  # its test episode is not read
    jax_ckpt = next(p for p in (tmp_path / "logs").rglob("ckpt_24_0.ckpt") if "jax_p2e" in str(p))
    jax_state = jax_load_state(str(jax_ckpt))
    assert {*TREES, "opt_states", "moments", "rb"} <= set(jax_state)

    # one exploration step of each package from the JAX checkpoint
    params, opt_states, moments = setup.restore_jax(jax_state)
    state = load_state(str(jax_ckpt))
    agent = setup.agent(state)
    optimizers = make_optimizers(setup.cfg, agent)
    port_moments = load_learner_state(state, agent, optimizers, "cpu")
    step = make_train_step(agent, optimizers, setup.cfg, False)
    batch = _p2e_batch(setup, 17)
    key = jax.random.PRNGKey(33)
    params, opt_states, moments, jax_metrics = setup.step(params, opt_states, moments,
                                                          {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                                          jnp.float32(0.02))
    port_moments, metrics = step(port_moments, {k: _t(v) for k, v in batch.items()}, 0.02, None, _noise(setup, key))
    np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4)
    # the metrics, trees and Moments, as the JEPA crossing test holds them
    # (the restored optax states are held exactly by the round-trip test)
    _assert_step_state(setup, params, opt_states, moments, agent, optimizers, port_moments, adam=False)

    # the port finetunes from the JAX exploration checkpoint, on its replay
    out = cli.run(_finetune_overrides(str(jax_ckpt)) + ["root_dir=port_ft"])
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    assert out["metric_order"] == METRIC_ORDER
    assert set(load_state(out["checkpoints"][-1])) >= {"world_model", "actor", "critic", "target_critic",
                                                       "actor_exploration", "opt_states", "moments"}

    # the port's exploration checkpoint, into the JAX finetuning
    out = cli.run(RUN + ["root_dir=port_p2e"])
    port_ckpt = out["checkpoints"][-1]
    assert jax_verify_checkpoint(port_ckpt) == (True, "verified")
    jax_state, state = jax_load_state(port_ckpt), load_state(port_ckpt)
    dv3_cfg = compose(_finetune_overrides(port_ckpt))
    jax_dv3_cfg = jax_compose(_finetune_overrides(port_ckpt))
    jax_params = jax.tree_util.tree_map(jnp.asarray, _jit_build(lambda: (jax_ft._build_agent(
        None, (2,), False, jax_dv3_cfg, GYM_OBS, jax_state)[3],))[0])
    jax_optimizers, jax_opts = jax_ft._make_optimizers(jax_dv3_cfg, jax_params, jax_state)
    jax_moments = jax_ft._init_moments(jax_dv3_cfg, jax_state)
    jax_step = jax_dv3_make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, jax_optimizers, jax_dv3_cfg,
                                       (2,), False)
    mapped = ft.finetuning_state(state)
    port = ft.build_agent((2,), False, dv3_cfg, OBS_SPACE, mapped)
    port_opts = make_optimizers(dv3_cfg, port)
    port_state = load_learner_state(mapped, port, port_opts, "cpu")
    dv3_step = make_dv3_train_step(port, port_opts, dv3_cfg, False)
    jax_params, _, _, jax_metrics = jax_step(jax_params, jax_opts, jax_moments,
                                             {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(0.02))[:4]
    _, metrics = dv3_step(port_state, {k: _t(v) for k, v in batch.items()}, 0.02, None, _jax_noise(setup, key))
    np.testing.assert_allclose(metrics[:len(METRIC_ORDER)].numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4)
    want, got = _leaves({k: jax_params[k] for k in ft.DV3_TREES}), _leaves(port.trees())
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)


def test_runs_switch_actors_evaluate_and_refuse_what_they_do_not_port(tmp_path, monkeypatch):
    """Exploration plays with its exploration actor throughout and tests the
    task actor zero-shot; finetuning switches actors at its first gradient
    step; ``eval`` runs on both checkpoints; ``serve`` refuses both, as the
    JAX package has no P2E adapter; ``run`` refuses ``skip_update`` for the
    exploration step and the model registry for both."""
    from sheeprl_tpu_torch.serving.loader import load_policy

    monkeypatch.chdir(tmp_path)
    explore = cli.run(RUN)
    assert explore["gradient_steps"] > 0 and np.isfinite(explore["metric_rows"]).all()
    assert [name for _, name in explore["player_actors"]] == ["actor_exploration"] and explore["test_steps"] > 0
    assert any("Rewards/intrinsic_intrinsic" in m for m in explore["logged"])
    ckpt = explore["checkpoints"][-1]
    finetune = cli.run(_finetune_overrides(ckpt))
    (first, before), (switch, after) = finetune["player_actors"]
    assert (before, after) == ("actor_exploration", "actor")
    assert first < finetune["first_train_iter"] < switch == finetune["first_train_iter"] + 1
    for path in (ckpt, finetune["checkpoints"][-1]):
        assert np.isfinite(cli.evaluation([f"checkpoint_path={path}", "fabric.accelerator=cpu"]))
        cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={path}", "fabric.accelerator=cpu"])
        with pytest.raises(ValueError, match="no servable adapter"):
            load_policy(cfg, ckpt_path, device)
    with pytest.raises(NotImplementedError, match="skip_update"):
        cli.run(RUN + ["diagnostics.enabled=True", "diagnostics.sentinel.enabled=True",
                       "diagnostics.sentinel.policy=skip_update"])
    for overrides in (RUN, _finetune_overrides(ckpt)):
        with pytest.raises(NotImplementedError, match="model registry"):
            cli.run(overrides + ["model_manager.disabled=False"])
