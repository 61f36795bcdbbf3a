"""The port's DroQ held to the JAX package's on the CPU at a test width
(hidden 8, two critics with dropout 0.25, batch 4 on a 10-dim ``state``):
the dropout critics with the JAX step's own keep-masks and
deterministically; two consecutive train calls of two gradient steps
against the JAX ``make_train_step`` with its four draws a step (the metrics,
every tree and Adam's moments); the loop on the dummy env with its action
space bounded, its checkpoints read and resumed by the JAX package and a JAX
checkpoint resumed and evaluated here; ``serve`` refusing a DroQ checkpoint;
the options ``run`` refuses.

The keep-masks come from a twin of the JAX critic with the same module
names, so the same dropout keys: its ``Dropout`` layers drop a tensor of
ones beside the real activations.  Tolerances as ``test_torch_sac.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sheeprl_tpu.algos.droq.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.droq.droq import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.droq.droq import make_train_step
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.interop.flax_params import dump_trees, optax_state, optimizer_state_dict, sac_spec
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_sac import (ACT_SPACE, GYM_ACT, GYM_OBS, OBS_SPACE, batch, check_moments, jit_build, leaves,
                            perturb, torch_tree)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["exp=droq", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "algo.hidden_size=8",
        "algo.critic.dropout=0.25", "algo.per_rank_batch_size=4", "algo.mlp_keys.encoder=[state]", "seed=3"]
G, B, H = 2, 4, 8


class _DroQQNetwork(nn.Module):
    """The JAX member with the same module names (so the same dropout
    keys); also returns each Dropout's keep-mask."""

    hidden_size: int = 256
    dropout: float = 0.01

    @nn.compact
    def __call__(self, obs, actions, deterministic=False):
        x = jnp.concatenate([obs, actions], axis=-1)
        masks = []
        for _ in range(2):
            x = nn.Dense(self.hidden_size)(x)
            kept = nn.Dropout(rate=self.dropout, deterministic=deterministic)(jnp.ones_like(x))
            masks.append(kept != 0)
            x = x * kept
            x = nn.LayerNorm()(x)
            x = jax.nn.relu(x)
        return nn.Dense(1)(x), masks


class _MaskedCritics(nn.Module):
    num_critics: int = 2
    hidden_size: int = 256
    dropout: float = 0.01

    @nn.compact
    def __call__(self, obs, actions, deterministic=False):
        vmapped = nn.vmap(_DroQQNetwork, in_axes=(None, None, None), out_axes=-1, axis_size=self.num_critics,
                          variable_axes={"params": 0}, split_rngs={"params": True, "dropout": True})(
            hidden_size=self.hidden_size, dropout=self.dropout)
        q, masks = vmapped(obs, actions, deterministic)
        return q[..., 0, :], masks


class Setup:
    def __init__(self, overrides=TINY):
        self.cfg, self.jax_cfg = compose(overrides), jax_compose(overrides)

        def init():
            actor_def, critic_def, params, target_entropy = jax_build_agent(None, self.jax_cfg, GYM_OBS, GYM_ACT)
            return actor_def, critic_def, target_entropy, params

        (self.actor_def, self.critic_def, self.target_entropy), params = jit_build(init)
        params = perturb(params)
        params["target_critic"] = perturb(params["critic"], 1)
        params["log_alpha"] = np.asarray([-0.4], np.float32)
        self.params = params
        self.masked = _MaskedCritics(2, H, 0.25)
        self.mask_fn = jax.jit(lambda p, o, a, k: self.masked.apply(p, o, a, False, rngs={"dropout": k})[1])

    def masks(self, key, rows):
        """The keep-masks of one critic call with ``key`` as ``[N, B, H]``
        tensors, one per hidden layer."""
        out = self.mask_fn(self.params["critic"], jnp.zeros((rows, 10)), jnp.zeros((rows, 2)), key)
        return [torch.from_numpy(np.asarray(m).transpose(2, 0, 1).copy()) for m in out]

    def optimizers(self, agent):
        from sheeprl_tpu_torch.config import instantiate

        a = self.cfg.algo
        return {"actor": instantiate(a.actor.optimizer)(agent.actor.parameters()),
                "critic": instantiate(a.critic.optimizer)(agent.critic.parameters()),
                "alpha": instantiate(a.alpha.optimizer)([agent.log_alpha])}

    def jax_optimizers(self):
        from sheeprl_tpu.config import instantiate as jax_instantiate

        a = self.jax_cfg.algo
        return {"actor": jax_instantiate(a.actor.optimizer), "critic": jax_instantiate(a.critic.optimizer),
                "alpha": jax_instantiate(a.alpha.optimizer)}


@pytest.fixture(scope="module")
def setup():
    return Setup()


def test_the_twin_draws_the_jax_critics_masks(setup):
    rng = np.random.default_rng(1)
    obs, act = rng.normal(size=(B, 10)).astype(np.float32), rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = setup.critic_def.apply(setup.params["critic"], obs, act, False, rngs={"dropout": key})
    got, masks = setup.masked.apply(setup.params["critic"], obs, act, False, rngs={"dropout": key})
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    kept = np.mean([np.asarray(m).mean() for m in masks])
    assert 0.5 < kept < 0.95  # rate 0.25: about three in four kept


def test_critics_match_the_jax_critics_with_masks_and_deterministically(setup):
    agent, _ = build_agent(setup.cfg, OBS_SPACE, ACT_SPACE, setup.params, "cpu")
    rng = np.random.default_rng(3)
    obs, act = rng.normal(size=(6, 10)).astype(np.float32), rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    p = setup.params["critic"]
    want = setup.critic_def.apply(p, obs, act, False, rngs={"dropout": key})
    got = agent.critic(torch.from_numpy(obs), torch.from_numpy(act), setup.masks(key, 6))
    assert got.shape == (6, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = setup.critic_def.apply(p, obs, act, True)
    got = agent.critic(torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    back = leaves(dump_trees(sac_spec(agent)))
    for path, value in leaves(setup.params).items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def _noise(setup, keys):
    """The JAX step's draws, in its split order: ``k_next, k_drop, k_actor,
    k_drop2``."""
    out = {"eps_next": [], "masks_critic": [[], []], "eps_actor": [], "masks_actor": [[], []]}
    for key in keys:
        k_next, k_drop, k_actor, k_drop2 = jax.random.split(key, 4)
        out["eps_next"].append(np.asarray(jax.random.normal(k_next, (B, 2))))
        out["eps_actor"].append(np.asarray(jax.random.normal(k_actor, (B, 2))))
        for name, k in (("masks_critic", k_drop), ("masks_actor", k_drop2)):
            for i, m in enumerate(setup.masks(k, B)):
                out[name][i].append(m)
    return {"eps_next": torch.from_numpy(np.stack(out["eps_next"])),
            "eps_actor": torch.from_numpy(np.stack(out["eps_actor"])),
            "masks_critic": [torch.stack(m) for m in out["masks_critic"]],
            "masks_actor": [torch.stack(m) for m in out["masks_actor"]]}


def _steps_from(setup, params, jax_opt_states=None, port_opt_states=None):
    jax_opts = setup.jax_optimizers()
    params = jax.tree_util.tree_map(jnp.asarray, params)
    if jax_opt_states is None:
        jax_opt_states = {"actor": jax_opts["actor"].init(params["actor"]),
                          "critic": jax_opts["critic"].init(params["critic"]),
                          "alpha": jax_opts["alpha"].init(params["log_alpha"])}
    jax_step = jax_make_train_step(setup.actor_def, setup.critic_def, jax_opts, setup.jax_cfg, -2.0)
    agent, _ = build_agent(setup.cfg, OBS_SPACE, ACT_SPACE, jax.tree_util.tree_map(np.asarray, params), "cpu")
    optimizers = setup.optimizers(agent)
    if port_opt_states is not None:
        spec = sac_spec(agent)
        specs = {"actor": spec["actor"], "critic": spec["critic"], "alpha": spec["log_alpha"]}
        for name, opt in optimizers.items():
            opt.load_state_dict(optimizer_state_dict(port_opt_states[name], opt, specs[name]))
    return [params, jax_opt_states, jax_step], agent, optimizers, make_train_step(agent, optimizers, setup.cfg, -2.0)


def _call_both(setup, jax_side, agent, optimizers, step, seed, rtol=1e-5):
    data = batch(seed)
    actor_data = {"observations": batch(seed + 1)["observations"]}
    keys = jax.random.split(jax.random.PRNGKey(seed + 2), G)
    params, opt_states, jax_step = jax_side
    params, opt_states, jax_metrics = jax_step(params, opt_states, jax.tree_util.tree_map(jnp.asarray, data),
                                               jax.tree_util.tree_map(jnp.asarray, actor_data), keys)
    jax_side[0], jax_side[1] = params, opt_states
    metrics = step(torch_tree(data), torch_tree(actor_data), _noise(setup, keys)).numpy()
    np.testing.assert_allclose(metrics[:3], np.asarray(jax_metrics), rtol=rtol, atol=1e-6)
    assert metrics[3] == 0
    got = leaves(dump_trees(sac_spec(agent)))
    for path, value in leaves(params).items():
        np.testing.assert_allclose(got[path], np.asarray(value), atol=1e-5, rtol=1e-5, err_msg=path)
    spec = sac_spec(agent)
    specs = {"actor": spec["actor"], "critic": spec["critic"], "alpha": spec["log_alpha"]}
    for name, opt in optimizers.items():
        ours = optax_state(opt, specs[name], clip=False)[0]
        assert int(ours[0].fields[0]) == int(opt_states[name][0].count)
        check_moments(ours, opt_states[name])


def test_two_train_calls_match_the_jax_step(setup):
    """Two calls of two gradient steps: the critic on the summed per-member
    MSE with its masks, the target EMA every step, the actor against the
    mean over the critics on the second batch with the second masks."""
    jax_side, agent, optimizers, step = _steps_from(setup, setup.params)
    for call in range(2):
        _call_both(setup, jax_side, agent, optimizers, step, 10 + 10 * call)


# --- the loop ----------------------------------------------------------------

RUN = ["exp=droq", "env=dummy", "env.id=continuous_dummy", "env.executor=sync", "env.capture_video=False",
       "fabric.accelerator=cpu", "env.num_envs=2", "algo.hidden_size=8", "algo.critic.dropout=0.25",
       "algo.per_rank_batch_size=4", "algo.replay_ratio=2", "algo.learning_starts=8", "algo.total_steps=24",
       "buffer.size=32", "buffer.checkpoint=True", "metric.logger=null", "metric.log_every=8",
       "checkpoint.every=12", "algo.mlp_keys.encoder=[state]", "seed=3"]


def bound_dummy_actions(monkeypatch, spaces_module, dummy_module):
    """Bound the continuous dummy env's actions to ``[-1, 1]`` in this
    process: its ``Box(-inf, inf)`` makes the tanh actor's rescale, and so
    every action and loss, NaN (ROADMAP.md Queue 3)."""
    orig = dummy_module.ContinuousDummyEnv.__init__

    def bounded(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.action_space = spaces_module.Box(-1.0, 1.0, shape=self.action_space.shape, dtype=np.float32)

    monkeypatch.setattr(dummy_module.ContinuousDummyEnv, "__init__", bounded)


@pytest.fixture
def bounded(monkeypatch):
    import gymnasium as gym

    from sheeprl_tpu.envs import dummy as jax_dummy
    from sheeprl_tpu_torch.envs import dummy, spaces

    bound_dummy_actions(monkeypatch, spaces, dummy)
    bound_dummy_actions(monkeypatch, gym.spaces, jax_dummy)


@pytest.fixture
def port_run(tmp_path, bounded):
    out = cli.run(RUN + [f"root_dir={tmp_path}"])
    assert len(out["checkpoints"]) == 2 and out["gradient_steps"] > 0
    return out


def _from_checkpoint(setup, ckpt):
    """One train call from a checkpoint in each package, restored as each
    loop restores it."""
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    state = jax_load_state(ckpt)
    jax_opts = setup.jax_optimizers()
    params = jax.tree_util.tree_map(jnp.asarray, state["agent"])
    init = {"actor": jax_opts["actor"].init(params["actor"]), "critic": jax_opts["critic"].init(params["critic"]),
            "alpha": jax_opts["alpha"].init(params["log_alpha"])}
    opt_states = jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=getattr(ref, "dtype", None)),
                                        init, state["opt_states"])
    jax_side, agent, optimizers, step = _steps_from(setup, state["agent"], opt_states, load_state(ckpt)["opt_states"])
    # a trained actor saturates the squash: 1 - tanh(x)^2 then carries the
    # two libraries' last-ulp tanh differences into the log-probs
    _call_both(setup, jax_side, agent, optimizers, step, 70, rtol=1e-3)
    return state


def test_run_checkpoints_verify_and_resume_in_the_jax_package_and_serve_refuses_them(setup, port_run):
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint

    rows = port_run["metric_rows"]
    assert rows.shape[1] == 3 and np.isfinite(rows).all() and port_run["health_rows"] == {}
    assert port_run["gradient_steps"] == 2 * (port_run["policy_steps"] - 6)  # the prefill's and each step's
    ckpt = port_run["checkpoints"][0]
    assert jax_verify_checkpoint(ckpt) == (True, "verified")
    state = _from_checkpoint(setup, ckpt)
    assert state["rb"]["buffer"]["next_observations"].shape == (32, 2, 10)
    assert np.isfinite(cli.evaluation([f"checkpoint_path={port_run['checkpoints'][-1]}", "fabric.accelerator=cpu"]))
    cfg, path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    from sheeprl_tpu_torch.serving.server import ServeApp

    with pytest.raises(ValueError, match="'droq' has no servable adapter"):
        ServeApp(cfg, path, device)


def test_a_jax_checkpoint_resumes_and_evaluates_in_the_port(setup, tmp_path, monkeypatch, bounded):
    from sheeprl_tpu.cli import run as jax_run

    monkeypatch.chdir(tmp_path)
    jax_run([o for o in RUN if o != "env.executor=sync"] + ["root_dir=jax_droq", "algo.run_test=False"])
    ckpts = sorted(tmp_path.rglob("*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [int(p.name.split("_")[1]) for p in ckpts] == [12, 24]
    _from_checkpoint(setup, str(ckpts[0]))
    out = cli.run(RUN + [f"checkpoint.resume_from={ckpts[0]}", "root_dir=port_resumed"])
    assert out["start_iter"] == 7 and out["policy_steps"] == 24 and np.isfinite(out["metric_rows"]).all()
    assert np.isfinite(cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"]))


@pytest.mark.parametrize("option", ["diagnostics.sentinel.policy=skip_update", "algo.offline.cql_alpha=1.0",
                                    "metric.profiler.enabled=True"])
def test_run_refuses_what_it_does_not_port(tmp_path, option):
    extra = ["diagnostics.sentinel.enabled=True"] if "sentinel" in option else []
    if option == "algo.offline.cql_alpha=1.0":
        # ported: the penalty's uniform proposals need finite action bounds,
        # and the dummy env's are infinite; the JAX step refuses it alike
        with pytest.raises(ValueError, match="needs finite action bounds"):
            cli.run(RUN + extra + [option, f"root_dir={tmp_path}"])
        return
    if option == "metric.profiler.enabled=True":
        # ported: cli.run_algorithm traces the whole run (tests/test_torch_records.py);
        # the loop refuses only skip_update
        from sheeprl_tpu_torch.algos.sac.sac import unported_options

        assert unported_options(compose(RUN + [option]), "DroQ", skip_update=False) == []
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.run(RUN + extra + [option, f"root_dir={tmp_path}"])
