"""The port's Plan2Explore-DV1 against the JAX package's, on the CPU at the
JAX package's P2E-DV1 test widths (``tests/test_algos/test_algos.py``:
8-unit layers, one layer, CNN multiplier 2, recurrent and hidden 8,
stochastic 8, an ensemble of 3 x 8 x 1, ``[rgb]`` and ``[state]`` encoded
and decoded), sequences of 4, batch 2 and horizon 3: the ensemble (elu, no
LayerNorm, as wide as the encoder's embedding) against the JAX vmapped
one; the converter on all six trees and the six optax states; two
consecutive exploration gradient steps against the JAX ``make_train_step``
for discrete and continuous (with the continue head) actions; finetuning's
state mapping; checkpoints across the two packages' loops; ``run``,
``eval`` and the refusals.  DreamerV1's GRU has no LayerNorm: no step
launches a kernel.

Random draws go through injected noise taken from the JAX keys with the
JAX step's own splits (``k_wm, k_img_e, k_img_t``, then per imagined step
``(k_act, k_dyn)``; ``p2e_dv1_exploration.py:91,99,107``).  Tolerances:
the ensemble 1e-5; parameters 2e-6 absolute and Adam's moments 1e-4 of
each tree's scale, as DreamerV1's; the metric vector to 1e-4 relative to
each entry's scale (``atol = 1e-4 * max(1, |want|)``, ``rtol = 1e-4``):
the intrinsic reward's multiplier of 10,000 puts the intrinsic reward, the
exploration values, lambda targets and losses at 1e2-1e5, where an
absolute 1e-4 would ask for more digits than fp32 holds; round trips
exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_dv1_make_train_step
from sheeprl_tpu.algos.p2e_dv1 import p2e_dv1_exploration as jax_ex
from sheeprl_tpu.algos.p2e_dv1 import p2e_dv1_finetuning as jax_ft
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import METRIC_ORDER as DV1_METRIC_ORDER
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_train_step as make_dv1_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import load_learner_state, make_optimizers
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_finetuning as ft
from sheeprl_tpu_torch.algos.p2e_dv1.agent import TREES, build_agent
from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration import METRIC_ORDER, make_train_step
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import finetuning_state, player_actor
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_dreamer_v2 import OBS, _spaces
from test_torch_dv3_train import _jit_build, _leaves, _record_margins, _t
from test_torch_p2e_dv3 import _opt_leaves, _port_opt_states
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T, B, H = 4, 2, 3
STOCH = 8
TINY = [
    "exp=p2e_dv1_exploration", "env=dummy", "env.capture_video=False", "env.screen_size=16", "algo.dense_units=8",
    "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8", f"algo.world_model.stochastic_size={STOCH}",
    "algo.ensembles.n=3", "algo.ensembles.dense_units=8",
    "algo.ensembles.mlp_layers=1", "algo.cnn_keys.encoder=[rgb]", "algo.cnn_keys.decoder=[rgb]",
    "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]", f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}", "run_name=tiny",
]
VECTOR_ONLY = ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]"]
FAMILIES = {"discrete": ("discrete_dummy", False, ()),
            # vector observations only, with the continue head, as
            # DreamerV1's continuous parity case
            "continuous": ("continuous_dummy", True, (*VECTOR_ONLY, "algo.world_model.use_continues=True"))}


class _Setup:
    """The JAX P2E-DV1 agent (through its loop's ``_build_agent``, which
    fills the step's ``_P2E``), every leaf perturbed, its config in both
    packages and its step."""

    def __init__(self, family: str, tiny=TINY):
        env_id, self.is_continuous, extra = FAMILIES[family]
        self.actions_dim = (2,)
        overrides = tiny + [f"env.id={env_id}", *extra]
        self.jax_cfg, self.cfg = jax_compose(overrides), compose(overrides)
        keys = list(self.cfg.algo.cnn_keys.encoder) + list(self.cfg.algo.mlp_keys.encoder)
        self.gym_obs, self.obs_space = _spaces(keys)

        def build():
            wm_def, actor_def, critic_def, params = jax_ex._build_agent(None, self.actions_dim, self.is_continuous,
                                                                        self.jax_cfg, self.gym_obs, None)
            return params, wm_def, actor_def, critic_def

        params, self.wm_def, self.actor_def, self.critic_def = _jit_build(build)
        self.ensemble_def = jax_ex._P2E["ensemble_def"]
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params)
        self.optimizers, _ = jax_ex._make_optimizers(self.jax_cfg, self.params, None)
        self.step = jax_ex.make_train_step(self.wm_def, self.actor_def, self.critic_def, self.optimizers,
                                           self.jax_cfg, self.actions_dim, self.is_continuous)

    def agent(self, state=None):
        return build_agent(self.actions_dim, self.is_continuous, self.cfg, self.obs_space,
                           self.params if state is None else state, "cpu")

    def restore_jax(self, state):
        """A checkpoint restored as the JAX exploration loop restores it."""
        jax_ex._P2E["ensemble_def"] = self.ensemble_def
        params = jax.tree_util.tree_map(jnp.asarray, _jit_build(lambda: (jax_ex._build_agent(
            None, self.actions_dim, self.is_continuous, self.jax_cfg, self.gym_obs, state)[3],))[0])
        return params, jax_ex._make_optimizers(self.jax_cfg, params, state)[1]

    def batch(self, seed: int):
        rng = np.random.default_rng(seed)
        actions = np.clip(rng.normal(size=(T, B, 2)), -1, 1) if self.is_continuous else \
            np.eye(2)[rng.integers(0, 2, (T, B))]
        terminated, is_first = np.zeros((T, B, 1)), np.zeros((T, B, 1))
        terminated[2, 0], is_first[3, 0] = 1.0, 1.0
        out = {"actions": actions, "rewards": rng.normal(size=(T, B, 1)), "terminated": terminated,
               "is_first": is_first}
        for k in self.obs_space.keys():
            out[k] = (rng.integers(0, 256, (T, B) + OBS[k]) / 255.0 - 0.5 if k == "rgb"
                      else rng.normal(size=(T, B) + OBS[k]))
        return {k: v.astype(np.float32) for k, v in out.items()}

    def noise(self, key):
        """The draws of the JAX P2E-DV1 step from ``key``, as port noise."""

        def draw(key):
            k_wm, k_img_e, k_img_t = jax.random.split(key, 3)
            return {"dynamic": _dynamic_noise(k_wm), "exploration": _imagination_noise(self, k_img_e),
                    "task": _imagination_noise(self, k_img_t)}

        return jax.tree_util.tree_map(_t, jax.jit(draw)(key))


def _dynamic_noise(k_wm):
    pairs = [jax.random.split(k) for k in jax.random.split(k_wm, T)]
    return (jnp.stack([jax.random.normal(p[0], (B, STOCH)) for p in pairs]),
            jnp.stack([jax.random.normal(p[1], (B, STOCH)) for p in pairs]))


def _imagination_noise(setup, k_img):
    """DreamerV1's imagination draws: per step ``(k_act, k_dyn)``, the
    prior's standard normal and the action's draw (tanh_normal's normal, a
    discrete head's Gumbel)."""
    img = [jax.random.split(k) for k in jax.random.split(k_img, H)]

    def actor_noise(k):
        if setup.is_continuous:
            return [jax.random.normal(k, (T * B, 2))]
        return [jax.random.gumbel(jax.random.fold_in(k, 0), (T * B, 2))]

    return {"imagination": jnp.stack([jax.random.normal(k[1], (T * B, STOCH)) for k in img]),
            "actor": [actor_noise(k[0]) for k in img]}


@pytest.fixture(scope="module")
def setups():
    return {}


def _setup(setups, family):
    if family not in setups:
        setups[family] = _Setup(family)
    return setups[family]


def _assert_step_state(params, opt_states, agent, optimizers, adam: bool = True):
    """The six trees and (with ``adam``) every optimizer's Adam moments of
    the two packages after their steps."""
    want, got = _leaves({k: params[k] for k in TREES}), _leaves(agent.trees())
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    want, got = _opt_leaves(opt_states), _opt_leaves(_port_opt_states(agent, optimizers))
    assert sorted(want) == sorted(got) == sorted(["world_model", "actor_task", "critic_task", "actor_exploration",
                                                  "critic_exploration", "ensembles"])
    for name, leaves in (want.items() if adam else ()):
        scale = max(float(np.abs(v).max()) for v in leaves.values())
        for path, value in leaves.items():
            np.testing.assert_allclose(got[name][path], value, atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")


def test_ensemble_forward_matches_the_jax_vmapped_ensemble(setups):
    setup = _setup(setups, "discrete")
    agent = setup.agent()
    ens = agent.ensembles
    # as wide as the encoder's embedding (rgb's 4 x 4 x 4 map and state's 8 units)
    with torch.no_grad():
        width = agent.world_model.encode({"rgb": torch.zeros(1, *OBS["rgb"]), "state": torch.zeros(1, *OBS["state"])})
    assert ens.out_kernel.shape[-1] == width.shape[-1] == 72
    x = np.random.default_rng(3).normal(size=(T, B, ens.kernels[0].shape[1])).astype(np.float32)
    want = jax.jit(lambda p, x: jax.vmap(lambda q: setup.ensemble_def.apply(q, x))(p))(setup.params["ensembles"], x)
    with torch.no_grad():
        got = ens(_t(x))
        # a member alone: Dense with its bias, DreamerV1's elu, the head
        member = torch.nn.functional.elu(_t(x) @ ens.kernels[0][1] + ens.dense_biases[0][1])
        member = member @ ens.out_kernel[1] + ens.out_bias[1]
    assert got.shape == want.shape == (3, T, B, 72)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(member.numpy(), got[1].numpy(), atol=1e-5, rtol=1e-5)


def test_converter_round_trips_the_six_trees_and_the_six_optax_states(setups, tmp_path):
    """Every leaf of the six trees back exactly; the six optax states,
    random values written by the JAX package, into the port's optimizers and
    back exactly."""
    from sheeprl_tpu.utils.checkpoint import save_state as jax_save_state

    setup = _setup(setups, "discrete")
    agent = setup.agent()
    back, want = _leaves(agent.trees()), _leaves(setup.params)
    assert sorted(back) == sorted(want) and sorted(agent.trees()) == sorted(TREES)
    assert any("ensembles']['params']['DenseStack_0']['Dense_0']['bias" in p for p in want)
    for path, value in want.items():
        assert back[path].dtype == value.dtype and np.array_equal(back[path], value), path

    _, opt_states = jax_ex._make_optimizers(setup.jax_cfg, setup.params, None)
    rng = np.random.default_rng(9)
    saved = jax.tree_util.tree_map(lambda a: np.asarray(3, np.int32) if np.asarray(a).dtype == np.int32 else
                                   rng.random(np.shape(a)).astype(np.float32), opt_states)
    jax_save_state(str(tmp_path / "opt.ckpt"), {"opt_states": saved, "moments": {}})
    state = load_state(str(tmp_path / "opt.ckpt"))
    optimizers = make_optimizers(setup.cfg, agent)
    assert load_learner_state(state, agent, optimizers, "cpu") == {}
    ours = _port_opt_states(agent, optimizers)
    want, got = _opt_leaves(saved), _opt_leaves(ours)
    assert sorted(want) == sorted(got) == sorted(opt_states)
    for name in want:
        for path, value in want[name].items():
            assert np.array_equal(got[name][path], value), f"{name}{path}"
    assert all(int(ours[n][1][0].fields[0]) == 3 for n in ours)


def _assert_metrics(got, want, where: str) -> None:
    """Each entry to 1e-4 of its own scale (the intrinsic terms carry the
    multiplier of 10,000)."""
    bad = np.abs(got - want) > 1e-4 * np.maximum(1.0, np.abs(want)) + 1e-4 * np.abs(want)
    assert not bad.any(), f"{where}: " + ", ".join(
        f"{name} {g!r} vs {w!r}" for name, g, w, b in zip(METRIC_ORDER, got, want, bad) if b)


@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_two_exploration_steps_match_make_train_step(family, setups, monkeypatch):
    """Two fp32 exploration steps from one set of converted params and the
    JAX step's noise: the metric vector (to each entry's scale), all six
    trees and the Adam moments of every optimizer; no kernel launch."""
    setup = _setup(setups, family)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    _, opt_states = jax_ex._make_optimizers(setup.jax_cfg, params, None)
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, setup.is_continuous)
    assert step.metric_order == jax_ex.METRIC_ORDER and step.health_names == []
    _record_margins(monkeypatch)
    batch = setup.batch(11)
    key = jax.random.PRNGKey(5)
    launches = fused_layernorm_gru.launches
    for i, tau in enumerate((1.0, 0.0)):
        key, sub = jax.random.split(key)
        params, opt_states, _, jax_metrics = setup.step(params, opt_states, {}, {k: jnp.asarray(v) for k, v in
                                                                                batch.items()}, sub, jnp.float32(tau))
        moments, metrics = step({}, {k: _t(v) for k, v in batch.items()}, tau, None, setup.noise(sub))
        got, want = metrics.numpy(), np.asarray(jax_metrics)
        assert moments == {} and np.isfinite(got).all() and got.shape == want.shape == (len(METRIC_ORDER),)
        _assert_metrics(got, want, f"step {i}")
    assert fused_layernorm_gru.launches == launches
    assert got[METRIC_ORDER.index("Rewards/intrinsic")] > 0  # the members disagree
    _assert_step_state(params, opt_states, agent, optimizers)


def _finetune_cfgs(ckpt: str = "x", extra=()):
    overrides = [o.replace("exp=p2e_dv1_exploration", "exp=p2e_dv1_finetuning") for o in TINY] + [
        "env.id=discrete_dummy", f"checkpoint.exploration_ckpt_path={ckpt}",
        *extra]
    return compose(overrides), jax_compose(overrides)


def test_finetuning_state_mapping_and_player_switch(setups, tmp_path):
    """An exploration checkpoint's task trees and optimizer states mapped as
    the JAX finetuning restores them; the exploration actor until the first
    gradient step, the task actor after it."""
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state
    from sheeprl_tpu_torch.utils.checkpoint import save_state

    setup = _setup(setups, "discrete")
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    rng = np.random.default_rng(4)
    for opt in optimizers.values():
        for p in [p for g in opt.param_groups for p in g["params"]]:
            opt.state[p] = {"step": torch.tensor(2.0), "exp_avg": torch.from_numpy(rng.random(p.shape).astype(
                np.float32)), "exp_avg_sq": torch.from_numpy(rng.random(p.shape).astype(np.float32))}
    save_state(str(tmp_path / "ckpt_1_0.ckpt"), {**agent.trees(), "opt_states": _port_opt_states(agent, optimizers)})
    jax_state, state = jax_load_state(str(tmp_path / "ckpt_1_0.ckpt")), load_state(str(tmp_path / "ckpt_1_0.ckpt"))
    cfg, jax_cfg = _finetune_cfgs()
    mapped = finetuning_state(state)
    assert "moments" not in mapped and "target_critic" not in mapped
    port = ft.build_agent((2,), False, cfg, setup.obs_space, mapped)
    port_opts = make_optimizers(cfg, port)
    assert load_learner_state(mapped, port, port_opts, "cpu") == {}
    jax_params = _jit_build(lambda: (jax_ft._build_agent(None, (2,), False, jax_cfg, setup.gym_obs, jax_state)[3],))[0]
    _, jax_opts = jax_ft._make_optimizers(jax_cfg, jax_params, jax_state)
    assert sorted(port.trees()) == sorted(jax_params) == sorted(ft.FinetuningAgent._fields)
    want, got = _leaves(jax_params), _leaves(port.trees())
    for path, value in want.items():
        assert np.array_equal(got[path], value), path
    want, got = _opt_leaves(jax_opts), _opt_leaves(_port_opt_states(port, port_opts))
    assert sorted(want) == sorted(got) == ["actor", "critic", "world_model"]
    for name in want:
        for path, value in want[name].items():
            assert np.array_equal(got[name][path], value), f"{name}{path}"
    # the player's actor, as the JAX finetuning's _player_actor picks it
    for actor_type in ("exploration", "task"):
        c = _finetune_cfgs(extra=[f"algo.player.actor_type={actor_type}"])[0]
        names = {"actor": "actor", "actor_exploration": "actor_exploration"}
        for has_trained in (False, True):
            assert player_actor(c)(has_trained) == names[jax_ft._player_actor(c)(names, has_trained)]


# a tiny run of each loop: learning from policy step 8 (2 envs), a replay
# ratio that owes the first gradient step some iterations after the player
# starts, a checkpoint every 8 policy steps with the replay
RUN = TINY + ["env.id=discrete_dummy", "fabric.accelerator=cpu",
              "algo.learning_starts=8", "algo.total_steps=24", "algo.replay_ratio=0.3", "buffer.size=64",
              "env.num_envs=2", "metric.log_every=8", "metric.logger=null", "checkpoint.every=8",
              "checkpoint.save_last=True", "buffer.checkpoint=True"]


def _finetune_overrides(ckpt: str):
    return [o.replace("exp=p2e_dv1_exploration", "exp=p2e_dv1_finetuning") for o in RUN] + [
        f"checkpoint.exploration_ckpt_path={ckpt}", "buffer.load_from_exploration=True"]


def test_checkpoints_cross_between_the_two_packages_loops(setups, tmp_path, monkeypatch):
    """The JAX exploration loop writes a checkpoint: one exploration step of
    each package from it agrees, the port resumes its exploration from it
    and finetunes from it.  The port's exploration checkpoint passes the
    JAX ``verify_checkpoint``; restored as the JAX finetuning restores it,
    one DreamerV1 step of each package agrees."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    monkeypatch.chdir(tmp_path)
    setup = _setup(setups, "discrete")
    # a resume waits algo.learning_starts again and keeps algo.total_steps:
    # the mid-run checkpoint of a longer run
    crossing = RUN + ["algo.total_steps=32"]
    jax_run(crossing + ["root_dir=jax_p2e", "algo.run_test=False"])
    jax_ckpt = next(p for p in (tmp_path / "logs").rglob("ckpt_16_0.ckpt") if "jax_p2e" in str(p))
    jax_state = jax_load_state(str(jax_ckpt))
    assert {*TREES, "opt_states", "rb"} <= set(jax_state) and not jax_state.get("moments")

    params, opt_states = setup.restore_jax(jax_state)
    state = load_state(str(jax_ckpt))
    agent = setup.agent(state)
    optimizers = make_optimizers(setup.cfg, agent)
    assert load_learner_state(state, agent, optimizers, "cpu") == {}
    step = make_train_step(agent, optimizers, setup.cfg, False)
    batch, key = setup.batch(17), jax.random.PRNGKey(33)
    params, opt_states, _, jax_metrics = setup.step(params, opt_states, {}, {k: jnp.asarray(v) for k, v in
                                                                             batch.items()}, key, jnp.float32(0.0))
    _, metrics = step({}, {k: _t(v) for k, v in batch.items()}, 0.0, None, setup.noise(key))
    _assert_metrics(metrics.numpy(), np.asarray(jax_metrics), "from the JAX checkpoint")
    # the restored optax states are held exactly by the round-trip test
    _assert_step_state(params, opt_states, agent, optimizers, adam=False)

    resumed = cli.run(crossing + ["root_dir=port_resumed", f"checkpoint.resume_from={jax_ckpt}",
                                  "algo.run_test=False"])
    assert resumed["start_iter"] == jax_state["iter_num"] + 1 and resumed["gradient_steps"] > 0
    out = cli.run(_finetune_overrides(str(jax_ckpt)) + ["root_dir=port_ft"])
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    assert out["metric_order"] == DV1_METRIC_ORDER
    assert set(load_state(out["checkpoints"][-1])) >= {*ft.FinetuningAgent._fields, "opt_states"}

    # the port's exploration checkpoint, into the JAX finetuning
    port_ckpt = resumed["checkpoints"][-1]
    assert jax_verify_checkpoint(port_ckpt) == (True, "verified")
    jax_state, state = jax_load_state(port_ckpt), load_state(port_ckpt)
    cfg, jax_cfg = _finetune_cfgs(port_ckpt)
    jax_params = jax.tree_util.tree_map(jnp.asarray, _jit_build(lambda: (jax_ft._build_agent(
        None, (2,), False, jax_cfg, setup.gym_obs, jax_state)[3],))[0])
    jax_optimizers, jax_opts = jax_ft._make_optimizers(jax_cfg, jax_params, jax_state)
    jax_step = jax_dv1_make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, jax_optimizers, jax_cfg)
    mapped = finetuning_state(state)
    port = ft.build_agent((2,), False, cfg, setup.obs_space, mapped)
    port_opts = make_optimizers(cfg, port)
    load_learner_state(mapped, port, port_opts, "cpu")
    dv1_step = make_dv1_train_step(port, port_opts, cfg, False)
    jax_params, _, jax_metrics = jax_step(jax_params, jax_opts, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    def dv1_draw(key):  # the JAX DreamerV1 step's draws (k_wm, k_img)
        k_wm, k_img = jax.random.split(key)
        return {"dynamic": _dynamic_noise(k_wm), **_imagination_noise(setup, k_img)}

    _, metrics = dv1_step({}, {k: _t(v) for k, v in batch.items()}, 0.0, None,
                          jax.tree_util.tree_map(_t, jax.jit(dv1_draw)(key)))
    np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4)
    want, got = _leaves({k: jax_params[k] for k in ft.FinetuningAgent._fields[:3]}), _leaves(port.trees())
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)


def test_runs_switch_actors_evaluate_and_refuse_what_they_do_not_port(tmp_path, monkeypatch):
    """Exploration plays with its exploration actor throughout and tests the
    task actor zero-shot; finetuning switches actors at its first gradient
    step; ``eval`` runs on both checkpoints; ``serve`` refuses both, as the
    JAX package has no P2E adapter; ``run`` refuses ``skip_update`` and the
    model registry for both."""
    from sheeprl_tpu_torch.serving.loader import load_policy

    monkeypatch.chdir(tmp_path)
    explore = cli.run(RUN)
    assert explore["gradient_steps"] > 0 and np.isfinite(explore["metric_rows"]).all()
    assert explore["metric_order"] == METRIC_ORDER
    assert [name for _, name in explore["player_actors"]] == ["actor_exploration"] and explore["test_steps"] > 0
    assert any("Rewards/intrinsic" in m for m in explore["logged"])
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
    for overrides in (RUN, _finetune_overrides(ckpt)):
        with pytest.raises(NotImplementedError, match="skip_update"):
            cli.run(overrides + ["diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=skip_update"])
        with pytest.raises(NotImplementedError, match="model registry"):
            cli.run(overrides + ["model_manager.disabled=False"])
