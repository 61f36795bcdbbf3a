"""The port's offline training (``algo.offline.enabled=true``,
``sheeprl_tpu_torch/offline/train.py``) and the conservative Q penalty held
to the JAX package's on the CPU at test widths: ``conservative_q_penalty``
with the JAX draws injected; SAC's and DroQ's two offline train calls with
``cql_alpha=1`` from converted params against the JAX ``make_train_step``
(metrics, every tree, Adam's moments); at ``cql_alpha=0`` the online steps
draw nothing new; ``check_configs``' offline gates; the offline loop on a
tiny dataset for ``dreamer_v3`` and ``sac`` (no env built; the first
gradient step's batch the JAX loop's; checkpoints marked offline that the
JAX ``verify_checkpoint`` passes); resumes: from an online checkpoint
(a fresh budget), from the port's own and from a JAX offline checkpoint
(the counters go on); and the JAX offline path's departures from upstream
(ROADMAP.md Queue 3).

Tolerances: the penalty 1e-6 absolute and 1e-5 relative; the train calls
as ``tests/test_torch_sac.py`` and ``tests/test_torch_droq.py`` hold the
online ones (metrics 1e-5 relative, parameters 1e-5, Adam's moments 1e-4 of
each tree's scale)."""

from __future__ import annotations

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac.loss import conservative_q_penalty as jax_conservative_q_penalty
from sheeprl_tpu.cli import check_configs as jax_check_configs
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.data import datasets as jax_datasets
from sheeprl_tpu.offline import train as jax_offline_train
from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.sac.loss import conservative_q_penalty
from sheeprl_tpu_torch.algos.sac.sac import SACFamily, cql_spec
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data import datasets
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.offline import train as offline_train
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_droq import TINY as DROQ_TINY
from test_torch_droq import Setup as DroQSetup
from test_torch_droq import _noise as droq_noise
from test_torch_droq import _steps_from as droq_steps_from
from test_torch_sac import B, G, TINY, Setup, Steps, batch, check_moments, leaves, torch_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

N_CQL = 3  # proposals of each kind
CQL = ["algo.offline.cql_alpha=1.0", f"algo.offline.cql_samples={N_CQL}"]


def cql_draws(key, n=N_CQL, b=B, low=(-1.0, -1.0), high=(1.0, 1.0)):
    """The JAX penalty's draws under ``key``: the uniform proposals and one
    standard normal per policy proposal (``split(k_pol, n)``)."""
    k_unif, k_pol = jax.random.split(key)
    low, high = jnp.asarray(np.float32(low)), jnp.asarray(np.float32(high))
    uniform = jax.random.uniform(k_unif, (n, b, low.shape[0]), minval=low, maxval=high, dtype=jnp.float32)
    eps = jnp.stack([jax.random.normal(k, (b, low.shape[0])) for k in jax.random.split(k_pol, n)])
    return np.array(uniform), np.array(eps)


@pytest.fixture(scope="module")
def setup():
    return Setup(TINY + CQL)


def test_the_penalty_matches_the_jax_function_on_its_own_draws(setup):
    agent = setup.agent()
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(B, 10)).astype(np.float32)
    actions = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    p = setup.params
    qf = np.array(setup.critic_def.apply(p["critic"], obs, actions), np.float32)
    key = jax.random.PRNGKey(7)
    want = jax_conservative_q_penalty(
        key, jnp.asarray(obs), jnp.asarray(qf),
        lambda o, k: setup.actor_def.apply(p["actor"], o, k, method="sample_and_log_prob"),
        lambda o, a: setup.critic_def.apply(p["critic"], o, a), np.float32([-1, -1]), np.float32([1, 1]), N_CQL)
    uniform, eps = cql_draws(key)
    got = conservative_q_penalty(torch.from_numpy(obs), torch.from_numpy(qf), agent.actor.sample_and_log_prob,
                                 agent.critic, torch.from_numpy(uniform), torch.from_numpy(eps))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-5)
    # its gradient reaches the critic and never the actor
    got.backward()
    assert all(p.grad is None for p in agent.actor.parameters())
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in agent.critic.parameters())


def test_two_offline_sac_calls_with_the_penalty_match_the_jax_step(setup):
    """``cql_alpha=1``: the JAX step splits each gradient step's key into
    the step's own and the penalty's; the port takes both draws injected."""
    steps = Steps(setup, CQL)
    assert steps.step.cql_samples == N_CQL
    for call in range(2):
        data = batch(10 + call)
        keys = jax.random.split(jax.random.PRNGKey(20 + call), G)
        out = steps.jax_step(steps.params, steps.opt_states, jax.tree_util.tree_map(jnp.asarray, data), keys)
        steps.params, steps.opt_states = out[0], out[1]
        eps, uniform, pol = [], [], []
        for key in keys:
            main, k_cql = jax.random.split(key)
            eps.append(np.asarray(jax.random.normal(main, (B, 2))))
            u, e = cql_draws(k_cql)
            uniform.append(u)
            pol.append(e)
        metrics = steps.step(torch_tree(data), torch.from_numpy(np.stack(eps)),
                             {"uniform": torch.from_numpy(np.stack(uniform)), "eps": torch.from_numpy(np.stack(pol))})
        np.testing.assert_allclose(metrics.numpy()[:5], np.asarray(out[2]), rtol=1e-5, atol=1e-6)
        steps.check_trees()
        steps.check_optimizers()


def test_two_offline_droq_calls_with_the_penalty_match_the_jax_step():
    """DroQ's penalty takes the deterministic critic pass; its key splits off
    before the step's four draws."""
    setup = DroQSetup(DROQ_TINY + CQL)
    jax_side, agent, optimizers, step = droq_steps_from(setup, setup.params)
    assert step.cql_samples == N_CQL
    for call in range(2):
        data, actor_data = batch(30 + call), {"observations": batch(40 + call)["observations"]}
        keys = jax.random.split(jax.random.PRNGKey(50 + call), G)
        params, opt_states, jax_metrics = jax_side[2](jax_side[0], jax_side[1], jax.tree_util.tree_map(jnp.asarray, data),
                                                      jax.tree_util.tree_map(jnp.asarray, actor_data), keys)
        jax_side[0], jax_side[1] = params, opt_states
        split = [jax.random.split(k) for k in keys]
        noise = droq_noise(setup, [s[0] for s in split])
        draws = [cql_draws(s[1]) for s in split]
        noise["cql_uniform"] = torch.from_numpy(np.stack([u for u, _ in draws]))
        noise["cql_eps"] = torch.from_numpy(np.stack([e for _, e in draws]))
        metrics = step(torch_tree(data), torch_tree(actor_data), noise).numpy()
        np.testing.assert_allclose(metrics[:3], np.asarray(jax_metrics), rtol=1e-5, atol=1e-6)
        from sheeprl_tpu_torch.interop.flax_params import dump_trees, optax_state, sac_spec

        got = leaves(dump_trees(sac_spec(agent)))
        for path, value in leaves(params).items():
            np.testing.assert_allclose(got[path], np.asarray(value), atol=1e-5, rtol=1e-5, err_msg=path)
        spec = sac_spec(agent)
        specs = {"actor": spec["actor"], "critic": spec["critic"], "alpha": spec["log_alpha"]}
        for name, opt in optimizers.items():
            check_moments(optax_state(opt, specs[name], clip=False)[0], opt_states[name])


def test_at_cql_alpha_0_the_online_steps_draw_nothing_new(setup, monkeypatch):
    """The online SAC and DroQ steps at the default ``cql_alpha=0``: no
    penalty is built or called, and a train call draws from the generator
    exactly what it drew before the penalty existed."""
    from sheeprl_tpu_torch.algos.droq import droq
    from sheeprl_tpu_torch.algos.sac import sac

    def boom(*args, **kwargs):
        raise AssertionError("the penalty ran at cql_alpha=0")

    monkeypatch.setattr(sac, "conservative_q_penalty", boom)
    monkeypatch.setattr(droq, "conservative_q_penalty", boom)
    cfg = compose(TINY)
    obs_space = spaces.Dict({"state": spaces.Box(-20, 20, (10,), np.float32)})
    action_space = spaces.Box(-1.0, 1.0, (2,), np.float32)
    family = SACFamily(cfg, obs_space, action_space, None, "cpu").make_update()
    assert family.cql_samples == 0 and family.cql_noise(G, B, torch.Generator()) is None

    class _Buffer:
        def sample(self, batch_size, n_samples, sample_next_obs=False):
            return batch(3, n_samples, batch_size)

    family.stager = lambda data: torch_tree(data)
    gen, twin = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    family.train(_Buffer(), B, G, gen, lambda d: d)
    torch.randn((G, B, 2), generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())
    dfam = droq.DroQFamily(compose(DROQ_TINY), obs_space, action_space, None, "cpu").make_update()
    a, b = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    before = droq.draw_noise(dfam.agent, G, B, 2, a, "cpu", dfam.cql_samples)
    assert sorted(before) == ["eps_actor", "eps_next", "masks_actor", "masks_critic"]
    dfam.update(torch_tree(batch(4)), {"observations": torch_tree(batch(5))["observations"]}, before)
    droq.draw_noise(dfam.agent, G, B, 2, b, "cpu")
    assert torch.equal(a.get_state(), b.get_state())


def test_an_armed_penalty_needs_finite_action_bounds():
    cfg = compose(TINY + CQL)
    unbounded = spaces.Box(-np.inf, np.inf, (2,), np.float32)
    obs_space = spaces.Dict({"state": spaces.Box(-20, 20, (10,), np.float32)})
    from sheeprl_tpu_torch.algos.sac.agent import build_agent

    agent, _ = build_agent(cfg, obs_space, unbounded, None, "cpu")
    with pytest.raises(ValueError, match="needs finite action bounds for its uniform action proposals"):
        cql_spec(cfg, agent.actor)
    assert cql_spec(compose(TINY), agent.actor) == (0.0, 4)


# --- the offline gates of check_configs ----------------------------------------

SAC_CLI = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "algo.total_steps=8",
           "algo.mlp_keys.encoder=[state]"]
ON = ["algo.offline.enabled=true", "algo.offline.dataset_dir=/data/sets/x"]


@pytest.mark.parametrize("extra, match", [
    (["algo.offline.enabled=true"], "requires algo.offline.dataset_dir"),
    ([*ON, "algo.offline.cql_alpha=-1"], "cql_alpha must be >= 0"),
    ([*ON, "algo.offline.cql_samples=0"], "cql_samples must be >= 1"),
    ([*ON, "algo.offline.grad_steps_per_iter=0"], "grad_steps_per_iter must be >= 1"),
    ([*ON, "algo.offline.prefetch=-1"], "prefetch must be >= 0"),
    ([*ON, "algo.offline.sequence_length=0"], "sequence_length must be >= 1 or null"),
    (["exp=ppo", "env.id=discrete_dummy", *ON], r"supports \['sac', 'droq', 'dreamer_v3'\]"),
    (["exp=sac_ae", *ON], r"supports \['sac', 'droq', 'dreamer_v3'\], got algo.name='sac_ae'"),
], ids=["dataset_dir", "cql_alpha", "cql_samples", "grad_steps", "prefetch", "sequence_length", "ppo", "sac_ae"])
def test_check_configs_raises_the_jax_errors_for_the_same_bad_knobs(extra, match):
    overrides = SAC_CLI + extra
    with pytest.raises(ValueError, match=match) as ours:
        cli.check_configs(compose(overrides))
    with pytest.raises(ValueError, match=match) as theirs:
        jax_check_configs(jax_compose(overrides))
    assert str(ours.value).split(" (")[0] == str(theirs.value).split(" (")[0]


def test_check_configs_passes_an_offline_run_and_warns_of_an_online_penalty():
    cli.check_configs(compose(SAC_CLI + ON))
    with pytest.warns(UserWarning, match="cql_alpha is set but algo.offline.enabled=false"):
        cli.check_configs(compose(SAC_CLI + ["algo.offline.cql_alpha=0.5"]))
    with pytest.warns(UserWarning, match="cql_alpha is set but algo.offline.enabled=false"):
        jax_check_configs(jax_compose(SAC_CLI + ["algo.offline.cql_alpha=0.5"]))


# --- the offline loop ---------------------------------------------------------

DV3_TINY = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "env.screen_size=16", "algo.dense_units=8",
            "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
            "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4", "algo.per_rank_batch_size=2",
            "algo.per_rank_sequence_length=4", "algo.horizon=3", "metric.logger=null", "seed=3",
            "algo.offline.actions_dim=[2]", "algo.offline.is_continuous=False"]
SAC_TINY = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "algo.hidden_size=8",
            "algo.per_rank_batch_size=4", "algo.mlp_keys.encoder=[state]", "metric.logger=null", "seed=3"]


def _dataset(root, kind: str, seed: int = 0):
    """A tiny dataset written by the JAX package: two streams of 24 steps,
    the DreamerV3 keys (16x16 ``rgb``, one-hot actions, episodes of 6) or
    the SAC family's (a 10-dim ``observations`` with its successor)."""
    rng = np.random.default_rng(seed)
    for stream in range(2):
        rows = 24
        if kind == "dv3":
            first = np.zeros((rows, 1), np.float32)
            first[::6] = 1
            term = np.roll(first, -1, axis=0)
            term[-1] = 0
            arrays = {"rgb": rng.integers(0, 256, (rows, 3, 16, 16), dtype=np.uint8),
                      "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)],
                      "rewards": rng.normal(size=(rows, 1)).astype(np.float32), "terminated": term,
                      "truncated": np.zeros((rows, 1), np.float32), "is_first": first}
        else:
            obs = rng.normal(size=(rows + 1, 10)).astype(np.float32)
            arrays = {"observations": obs[:-1], "next_observations": obs[1:],
                      "actions": rng.uniform(-1, 1, (rows, 2)).astype(np.float32),
                      "rewards": rng.normal(size=(rows, 1)).astype(np.float32),
                      "terminated": (rng.random((rows, 1)) < 0.1).astype(np.float32),
                      "truncated": np.zeros((rows, 1), np.float32)}
        jax_datasets.write_shard(str(root), stream, 0, arrays)
    jax_datasets.write_dataset_meta(str(root), {"kind": kind})
    return str(root)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline_data")
    return {"dv3": _dataset(root / "dv3", "dv3"), "sac": _dataset(root / "sac", "sac"), "root": root}


def _recording(monkeypatch, cls, store):
    """``cls.batches`` records the first batch its iterator yields."""
    orig = cls.batches

    def batches(self, *args, **kwargs):
        it = orig(self, *args, **kwargs)

        def gen():
            for i, item in enumerate(it):
                if i == 0:
                    store.append({k: np.array(v) for k, v in item.items()})
                yield item

        return gen()

    monkeypatch.setattr(cls, "batches", batches)


class _Stop(Exception):
    pass


def test_offline_dreamer_v3_trains_on_the_jax_loops_first_batch_with_no_env(data_dirs, tmp_path, monkeypatch):
    """The port's loop builds no env, trains its gradient steps on the
    loader's batches (the first the JAX loop's, which is stopped at its
    first step), and writes checkpoints marked offline that the JAX
    ``verify_checkpoint`` passes; a resume from the first continues its
    counters."""
    from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.envs import env as env_module

    monkeypatch.chdir(tmp_path)
    for name in ("make_env", "make_env_fns"):
        monkeypatch.setattr(env_module, name, lambda *a, **k: (_ for _ in ()).throw(AssertionError("env built")))
    ours, theirs = [], []
    _recording(monkeypatch, datasets.OfflineDataset, ours)
    _recording(monkeypatch, jax_datasets.OfflineDataset, theirs)
    overrides = DV3_TINY + ["algo.offline.enabled=true", f"algo.offline.dataset_dir={data_dirs['dv3']}",
                            "algo.total_steps=4", "algo.offline.grad_steps_per_iter=2", "checkpoint.every=2",
                            "algo.run_test=False"]
    out = cli.run(overrides + ["fabric.accelerator=cpu", "root_dir=port"])
    assert out["gradient_steps"] == 4 and out["iterations"] == 2 and np.isfinite(out["metric_rows"]).all()
    assert out["dataset"]["rows"] == 48 and len(out["checkpoints"]) == 2

    def stop(*args, **kwargs):
        def step(*a, **k):
            raise _Stop

        return step

    monkeypatch.setattr(jax_dv3, "make_train_step", stop)
    with pytest.raises(_Stop):
        jax_run(overrides + ["fabric.accelerator=cpu", "root_dir=jax"])
    assert sorted(ours[0]) == sorted(theirs[0])
    for k in theirs[0]:
        np.testing.assert_array_equal(ours[0][k], theirs[0][k], err_msg=k)

    for ckpt in out["checkpoints"]:
        state = load_state(ckpt)
        assert jax_verify_checkpoint(ckpt) == (True, "verified")
        assert state["offline"] is True and {"world_model", "actor", "critic", "target_critic", "opt_states",
                                             "moments"} <= set(state)
    resumed = cli.run(overrides + [f"checkpoint.resume_from={out['checkpoints'][0]}", "run_name=resumed",
                                   "fabric.accelerator=cpu"])
    assert resumed["start_iter"] == 2 and resumed["policy_steps"] == 4 and resumed["gradient_steps"] == 2


@pytest.fixture(scope="module")
def jax_sac(data_dirs):
    """The JAX offline SAC loop on the tiny dataset with the penalty, its
    first batch recorded: 4 iterations of 2 gradient steps, a checkpoint
    every 4 steps."""
    from sheeprl_tpu.cli import run as jax_run

    store = []
    mp = pytest.MonkeyPatch()
    _recording(mp, jax_datasets.OfflineDataset, store)
    cwd = os.getcwd()
    os.chdir(data_dirs["root"])
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jax_run(SAC_TINY + CQL + ["algo.offline.enabled=true", f"algo.offline.dataset_dir={data_dirs['sac']}",
                                      "algo.total_steps=8", "algo.offline.grad_steps_per_iter=2",
                                      "checkpoint.every=4", "fabric.accelerator=cpu", "algo.run_test=False",
                                      "root_dir=jax_sac"])
    finally:
        os.chdir(cwd)
        mp.undo()
    ckpts = sorted(data_dirs["root"].joinpath("logs").rglob("*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    return {"first_batch": store[0], "checkpoints": [str(p) for p in ckpts]}


def test_offline_sac_with_the_penalty_trains_on_the_jax_loops_first_batch(data_dirs, jax_sac, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ours = []
    _recording(monkeypatch, datasets.OfflineDataset, ours)
    out = cli.run(SAC_TINY + CQL + ["algo.offline.enabled=true", f"algo.offline.dataset_dir={data_dirs['sac']}",
                                    "algo.total_steps=8", "algo.offline.grad_steps_per_iter=2", "checkpoint.every=4",
                                    "fabric.accelerator=cpu", "algo.run_test=False", "root_dir=port"])
    assert out["gradient_steps"] == 8 and np.isfinite(out["metric_rows"]).all()
    assert out["family"].cql_samples == N_CQL and out["metric_rows"].shape == (4, 4)
    for k in jax_sac["first_batch"]:
        np.testing.assert_array_equal(ours[0][k], jax_sac["first_batch"][k], err_msg=k)
    assert [int(os.path.basename(c).split("_")[1]) for c in out["checkpoints"]] == [4, 8]
    for ckpt in out["checkpoints"]:
        assert jax_verify_checkpoint(ckpt) == (True, "verified") and load_state(ckpt)["offline"] is True


def test_a_jax_offline_checkpoint_resumes_in_the_port_and_the_counters_go_on(jax_sac, data_dirs, tmp_path,
                                                                               monkeypatch):
    monkeypatch.chdir(tmp_path)
    first = jax_sac["checkpoints"][0]
    state = load_state(first)
    assert bool(state["offline"]) and state["policy_step"] == 4  # the JAX save stores the flag as an array
    out = cli.run(SAC_TINY + CQL + ["algo.offline.enabled=true", f"algo.offline.dataset_dir={data_dirs['sac']}",
                                    "algo.total_steps=8", "algo.offline.grad_steps_per_iter=2",
                                    f"checkpoint.resume_from={first}", "fabric.accelerator=cpu", "run_name=resumed"])
    assert out["start_iter"] == state["iter_num"] + 1 == 3 and out["policy_steps"] == 8
    assert out["gradient_steps"] == 4 and np.isfinite(out["metric_rows"]).all()


def test_a_resume_from_an_online_checkpoint_starts_a_fresh_offline_budget(data_dirs, tmp_path, monkeypatch):
    """An online SAC run's checkpoint (its counters count env iterations)
    restores the agent and optimizers and trains the whole offline budget
    from step 0, as the JAX loop's ``_resume_counters`` says."""
    from sheeprl_tpu_torch.envs import dummy

    monkeypatch.chdir(tmp_path)
    orig = dummy.ContinuousDummyEnv.__init__

    def bounded(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.action_space = spaces.Box(-1.0, 1.0, self.action_space.shape, np.float32)

    monkeypatch.setattr(dummy.ContinuousDummyEnv, "__init__", bounded)
    online = cli.run(SAC_TINY + ["env.num_envs=2", "env.executor=sync", "algo.learning_starts=8",
                                 "algo.total_steps=16", "buffer.size=32", "fabric.accelerator=cpu",
                                 "algo.run_test=False", "root_dir=online"])
    ckpt = online["checkpoints"][-1]
    assert load_state(ckpt)["iter_num"] == 8 and "offline" not in load_state(ckpt)
    out = cli.run(SAC_TINY + ["env.num_envs=2", "algo.total_steps=16", "algo.offline.enabled=true",
                              f"algo.offline.dataset_dir={data_dirs['sac']}", "algo.offline.grad_steps_per_iter=4",
                              f"checkpoint.resume_from={ckpt}", "fabric.accelerator=cpu", "run_name=finetune"])
    assert out["start_iter"] == 1 and out["policy_steps"] == 16 and out["gradient_steps"] == 16
    assert offline_train._resume_counters(load_state(ckpt)) == jax_offline_train._resume_counters(load_state(ckpt))
    assert offline_train._resume_counters(load_state(out["checkpoints"][-1]))[0] == 5


def test_offline_run_refuses_the_card_it_does_not_have(data_dirs, monkeypatch):
    """No fallback: without ``fabric.accelerator=cpu`` an offline run needs
    a CUDA device."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(SAC_TINY + ["algo.offline.enabled=true", f"algo.offline.dataset_dir={data_dirs['sac']}"])


# --- where the JAX offline path departs from upstream (ROADMAP.md Queue 3) ---


def test_the_offline_action_space_defaults_to_plus_minus_one_in_both_packages():
    """Neither dataset records the collecting env's action bounds: with no
    ``algo.offline.action_low/high`` both packages train in ``[-1, 1]``."""
    ours = offline_train._offline_action_space(3, {})
    theirs = jax_offline_train._offline_action_space(3, {})
    for space in (ours, theirs):
        np.testing.assert_array_equal(space.low, -np.ones(3, np.float32))
        np.testing.assert_array_equal(space.high, np.ones(3, np.float32))
    np.testing.assert_array_equal(offline_train._offline_action_space(2, {"action_low": -2, "action_high": 3}).high,
                                  [3, 3])
    for package in (offline_train, jax_offline_train):
        with pytest.raises(ValueError, match="must be finite"):
            package._offline_action_space(2, {"action_high": float("inf")})


def test_an_unannotated_dreamer_dataset_trains_a_continuous_actor(data_dirs, tmp_path, monkeypatch):
    """Without ``algo.offline.actions_dim`` the JAX loop reads the stored
    one-hot actions as one continuous vector; so does the port's: the agent
    it trains is continuous, whatever the collecting env's actions were."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    monkeypatch.chdir(tmp_path)
    seen = {}
    orig = dreamer_v3.build_dreamer_agent

    def spy(actions_dim, is_continuous, *args, **kwargs):
        seen.update(actions_dim=tuple(actions_dim), is_continuous=is_continuous)
        return orig(actions_dim, is_continuous, *args, **kwargs)

    monkeypatch.setattr(dreamer_v3, "build_dreamer_agent", spy)
    overrides = [o for o in DV3_TINY if not o.startswith("algo.offline")]
    cli.run(overrides + ["algo.offline.enabled=true", f"algo.offline.dataset_dir={data_dirs['dv3']}",
                         "algo.total_steps=1", "algo.offline.grad_steps_per_iter=1", "fabric.accelerator=cpu",
                         "algo.run_test=False", "checkpoint.save_last=False"])
    assert seen == {"actions_dim": (2,), "is_continuous": True}
