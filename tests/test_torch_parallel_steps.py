"""The port's two-shard train steps against the JAX ``make_train_step`` on
two virtual CPU devices (the suite's ``--xla_force_host_platform_device_count``).

For each family: two consecutive steps from converted params, the JAX step
``shard_map``-ed over a two-device ``data`` mesh, the port's as two shards,
each with its own replica of the agent and optimizers, run in lockstep by
``parallel/dp.py::run_shards`` on the shards' blocks of the same global
batch (shard d takes rows ``[d * B, (d + 1) * B)``).  Each shard's random
draws are injected from the JAX keys as the JAX step folds them
(``fold_in(key, axis_index)``: DreamerV3, PPO, PPO-recurrent, DroQ, SAC-AE)
or shares them (SAC, whose step folds no key).  After each step the
replicas hold the same bytes, and shard 0's metrics, parameters and
optimizer state agree with the JAX step's within the tolerances of each
family's one-device parity test.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.parallel.mesh import make_mesh
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.parallel.dp import replicas_equal, run_shards, split
from sheeprl_tpu_torch.parallel.mesh import replicate
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

SHARDS = 2
CPU = [torch.device("cpu")] * SHARDS


def _mesh():
    return make_mesh(n_devices=SHARDS)


def _folded(key):
    """Each shard's key, as ``parallel/dp.py::fold_key`` folds it."""
    return [jax.random.fold_in(key, d) for d in range(SHARDS)]


def _two(make):
    """Two replicas from ``make() -> (modules, optimizers, step)``: shard
    1's modules a deep copy of shard 0's, its optimizers and step built on
    them as ``make_optimizers(modules)`` and ``make_step(modules, optimizers)``
    say."""
    modules, make_optimizers, make_step = make()
    replicas = replicate(modules, CPU)
    optimizers = [make_optimizers(r) for r in replicas]
    steps = [make_step(r, o) for r, o in zip(replicas, optimizers)]
    return replicas, optimizers, steps


def _equal(replicas, optimizers):
    assert replicas_equal([[r, o] for r, o in zip(replicas, optimizers)]), "the replicas diverged"


# ---------------------------------------------------------------------------
# DreamerV3


def _dreamer_v3(setups, monkeypatch):
    import test_torch_dv3_train as dv3
    from sheeprl_tpu.algos.dreamer_v3 import utils as jax_utils
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_optimizers, make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state

    setup = setups("dreamer_v3", lambda: dv3._Setup(
        "continuous_dummy", (2,), True, ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]",
                                         f"algo.per_rank_batch_size={dv3.B}"]))
    cfg, jax_cfg = setup.cfg, setup.jax_cfg
    opts = {k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients),
                           jax_instantiate(jax_cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: opts[k].init(params[k]) for k in opts}
    if not hasattr(setup, "dp_step"):
        setup.dp_step = jax_make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, opts, jax_cfg,
                                            setup.actions_dim, setup.is_continuous, mesh=_mesh())
    moments = jax_utils.init_moments_state()
    replicas, optimizers, steps = _two(lambda: (setup.agent(), lambda a: make_optimizers(cfg, a),
                                                lambda a, o: make_train_step(a, o, cfg, setup.is_continuous)))
    state = init_moments_state()
    dv3._record_margins(monkeypatch)
    # the global batch: two shards of dv3.B sequences
    batch = {k: np.concatenate([v, w], axis=1).astype(np.float32)
             for (k, v), w in zip(dv3._batch(setup, 11).items(), dv3._batch(setup, 12).values())}
    blocks = [{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()} for b in split(batch, SHARDS, 1)]
    key = jax.random.PRNGKey(5)
    for i, tau in enumerate((1.0, 0.02)):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics = setup.dp_step(
            params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, sub, jnp.float32(tau))[:4]
        outs = run_shards([step.body({k: v.clone() for k, v in state.items()}, block, tau, None,
                                     dv3._jax_noise(setup, k))
                           for step, block, k in zip(steps, blocks, _folded(sub))])
        state, metrics = outs[0]
        assert all(torch.equal(m, metrics) for _, m in outs[1:])
        _equal([list(r) for r in replicas], [list(o.values()) for o in optimizers])
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}: {METRIC_ORDER}")
    want = dv3._leaves({k: params[k] for k in ("world_model", "actor", "critic", "target_critic")})
    got = dv3._leaves(dv3.to_flax(*replicas[0]))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    moments_got = dv3._adam_moments(replicas[0], optimizers[0])
    for name in ("world_model", "actor", "critic"):
        adam_state = opt_states[name][1][0]
        for slot, tree in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu)):
            w, g = dv3._leaves(tree), dv3._leaves(moments_got[name][slot])
            scale = max(float(np.abs(v).max()) for v in w.values())
            for path in w:
                np.testing.assert_allclose(g[path], w[path], atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")
    np.testing.assert_allclose(state["low"].numpy(), np.asarray(moments["low"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state["high"].numpy(), np.asarray(moments["high"]), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# PPO and A2C


def _torch_rows(data):
    return {k: ({kk: torch.from_numpy(np.ascontiguousarray(vv)) for kk, vv in v.items()} if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v))) for k, v in data.items()}


def _ppo(setups, monkeypatch):
    import test_torch_ppo as tp
    from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.ppo.ppo import linear_schedule, make_train_step

    s = setups("ppo", lambda: tp._Setup("discrete"))
    n, mb, total_updates = 8, 2, 10  # rows and minibatches a shard
    opt = tp._jax_optimizer(s.jax_cfg, total_updates)
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_make_train_step(s.jax_agent, opt, copy.deepcopy(s.jax_cfg), _mesh(), mb, 4)
    params, opt_state = jax.tree_util.tree_map(jnp.asarray, s.params), opt.init(s.params)
    schedule = linear_schedule(s.cfg.algo.optimizer.learning_rate, 0.0, total_updates)
    replicas, optimizers, steps = _two(lambda: (
        tp.build_agent(s.actions_dim, s.continuous, s.cfg, s.obs_space, s.params, "cpu"),
        lambda a: instantiate(s.cfg.algo.optimizer)(a.parameters()),
        lambda a, o: make_train_step(a, o, s.cfg, mb, int(s.cfg.algo.per_rank_batch_size), schedule)))
    for it in range(2):
        data = tp._data(SHARDS * n, s, 10 + it)
        key = jax.random.PRNGKey(20 + it)
        coefs = (0.2 - 0.05 * it, 0.01, 0.5)
        out = s.dp_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data), key,
                        tuple(jnp.float32(c) for c in coefs))
        params, opt_state = out[0], out[1]
        bodies = []
        for step, block, k in zip(steps, split(data, SHARDS, 0), _folded(key)):
            perms = [torch.from_numpy(np.array(jax.random.permutation(e, n))) for e in jax.random.split(k, 2)]
            bodies.append(step.body(_torch_rows(block), perms, coefs))
        metrics = run_shards(bodies)[0]
        _equal(replicas, optimizers)
        tp._check_update(s, jax.tree_util.tree_map(np.asarray, out), replicas[0], optimizers[0], metrics,
                         steps[0].health_names)


def _a2c(setups, monkeypatch):
    import test_torch_a2c as ta
    from sheeprl_tpu.algos.a2c.a2c import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.a2c.a2c import make_train_step

    # the clip, normalized advantages (over the shards) and `mean`
    s = setups("a2c", lambda: ta._Setup("multidiscrete"))
    tx = s.jax_optimizer()
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_make_train_step(s.jax_agent, tx, s.jax_cfg, _mesh())
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    opt_state = tx.init(params)
    replicas, optimizers, steps = _two(lambda: (s.agent(), lambda a: instantiate(s.cfg.algo.optimizer)(a.parameters()),
                                                lambda a, o: make_train_step(a, o, s.cfg)))
    for it in range(2):
        data = ta._data(SHARDS * 8, s, 10 + it)
        out = s.dp_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data))
        params, opt_state = out[0], out[1]
        metrics = run_shards([step.body(_torch_rows(block)) for step, block in zip(steps, split(data, SHARDS, 0))])[0]
        _equal(replicas, optimizers)
        ta._check_update(s, out, replicas[0], optimizers[0], metrics, steps[0].health_names,
                         bool(s.cfg.algo.max_grad_norm))


def _ppo_recurrent(setups, monkeypatch):
    import test_torch_ppo_recurrent as tr
    from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_train_step
    from sheeprl_tpu_torch.interop.flax_params import optax_state, ppo_recurrent_spec

    s = setups("ppo_recurrent", lambda: tr._Setup("discrete"))
    optimizer = optax.chain(optax.clip_by_global_norm(s.jax_cfg.algo.max_grad_norm),
                            jax_instantiate(s.jax_cfg.algo.optimizer))
    seq_batch = tr.S // 2  # each shard: S sequences in 2 minibatches
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_make_train_step(s.jax_agent, optimizer, s.jax_cfg, _mesh(), 2, seq_batch)
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    opt_state = optimizer.init(params)
    replicas, optimizers, steps = _two(lambda: (s.agent(), lambda a: instantiate(s.cfg.algo.optimizer)(a.parameters()),
                                                lambda a, o: make_train_step(a, o, s.cfg, 2, seq_batch)))
    coefs = (0.2, 0.01, 0.5)
    for it in range(2):
        parts = [tr._update_data(s, 11 + 10 * it + d) for d in range(SHARDS)]
        data = {k: ({kk: np.concatenate([p[k][kk] for p in parts], 1) for kk in v} if isinstance(v, dict)
                    else np.concatenate([p[k] for p in parts], 0 if k in ("hx0", "cx0") else 1))
                for k, v in parts[0].items()}
        key = jax.random.PRNGKey(21 + it)
        params, opt_state, losses = s.dp_step(params, opt_state, tr._jax_data(data), key,
                                              tuple(jnp.float32(c) for c in coefs))
        metrics = run_shards([step.body(tr._port_data(p), tr._perms(k, 2, tr.S), coefs)
                              for step, p, k in zip(steps, parts, _folded(key))])[0]
        _equal(replicas, optimizers)
        np.testing.assert_allclose(metrics[:3].numpy(), np.asarray(losses), atol=1e-5, rtol=1e-4)
        assert metrics[3] == 0
    want, got = tr._leaves(params), tr._leaves(tr.ppo_recurrent_spec_dump(replicas[0]))
    assert sorted(want) == sorted(got)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    adam = opt_state[1][0]
    mine = optax_state(optimizers[0], ppo_recurrent_spec(replicas[0]))[1][0]
    for slot, tree in ((1, adam.mu), (2, adam.nu)):
        w, g = tr._leaves(tree), tr._leaves(mine.fields[slot])
        scale = max(float(np.abs(v).max()) for v in w.values())
        for path in w:
            np.testing.assert_allclose(g[path], w[path], atol=1e-4 * scale, rtol=1e-3, err_msg=path)


# ---------------------------------------------------------------------------
# SAC, DroQ, SAC-AE


def _sac(setups, monkeypatch):
    import test_torch_sac as ts
    from sheeprl_tpu.algos.sac.sac import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.sac.sac import make_train_step

    setup = setups("sac", lambda: ts.Setup(ts.TINY))
    steps_1 = ts.Steps(setup)  # the JAX params and states, the port's trees and optimizer checks
    if not hasattr(setup, "dp_step"):
        setup.dp_step = jax_make_train_step(setup.actor_def, setup.critic_def, steps_1.jax_opts, steps_1.jax_cfg,
                                            _mesh(), setup.target_entropy)
    replicas, optimizers, steps = _two(lambda: (steps_1.agent, setup.optimizers,
                                                lambda a, o: make_train_step(a, o, steps_1.cfg, -2.0)))
    steps_1.agent, steps_1.optimizers = replicas[0], optimizers[0]
    for call in range(2):
        data = ts.batch(10 + call, b=SHARDS * ts.B)
        keys = ts.jax_keys(20 + call)
        out = setup.dp_step(steps_1.params, steps_1.opt_states, jax.tree_util.tree_map(jnp.asarray, data), keys)
        steps_1.params, steps_1.opt_states = out[0], out[1]
        eps = ts.eps_of(keys)  # the step folds no key: every shard draws the same
        metrics = run_shards([step.body(ts.torch_tree(block), eps.clone())
                              for step, block in zip(steps, split(data, SHARDS, 1))])[0].numpy()
        _equal(replicas, optimizers)
        np.testing.assert_allclose(metrics[:5], np.asarray(out[2]), rtol=1e-5, atol=1e-6)
        health = dict(zip(steps[0].health_names, metrics[5:]))
        assert sorted(health) == sorted(out[3]) and "module/alpha/update_ratio" in health
        for k, v in out[3].items():
            tol = 1e-6 if k.endswith("dead_frac") else 1e-4
            np.testing.assert_allclose(health[k], float(v), rtol=tol, atol=tol / 10, err_msg=k)
        steps_1.check_trees()
        steps_1.check_optimizers()


def _droq(setups, monkeypatch):
    import test_torch_droq as td
    import test_torch_sac as ts
    from sheeprl_tpu.algos.droq.droq import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.droq.agent import build_agent
    from sheeprl_tpu_torch.algos.droq.droq import make_train_step
    from sheeprl_tpu_torch.interop.flax_params import dump_trees, optax_state, sac_spec

    setup = setups("droq", td.Setup)
    jax_opts = setup.jax_optimizers()
    if not hasattr(setup, "dp_step"):
        setup.dp_step = jax_make_train_step(setup.actor_def, setup.critic_def, jax_opts, setup.jax_cfg, -2.0,
                                            mesh=_mesh())
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {"actor": jax_opts["actor"].init(params["actor"]), "critic": jax_opts["critic"].init(params["critic"]),
                  "alpha": jax_opts["alpha"].init(params["log_alpha"])}
    replicas, optimizers, steps = _two(lambda: (
        build_agent(setup.cfg, ts.OBS_SPACE, ts.ACT_SPACE, setup.params, "cpu")[0], setup.optimizers,
        lambda a, o: make_train_step(a, o, setup.cfg, -2.0)))
    for call in range(2):
        seed = 10 + 10 * call
        data = ts.batch(seed, b=SHARDS * td.B)
        actor_data = {"observations": ts.batch(seed + 1, b=SHARDS * td.B)["observations"]}
        keys = jax.random.split(jax.random.PRNGKey(seed + 2), td.G)
        params, opt_states, jax_metrics = setup.dp_step(params, opt_states, jax.tree_util.tree_map(jnp.asarray, data),
                                                        jax.tree_util.tree_map(jnp.asarray, actor_data), keys)
        bodies = []
        for d, (step, block, actor_block) in enumerate(zip(steps, split(data, SHARDS, 1), split(actor_data, SHARDS, 1))):
            noise = td._noise(setup, jnp.stack([jax.random.fold_in(k, d) for k in keys]))
            bodies.append(step.body(ts.torch_tree(block), ts.torch_tree(actor_block), noise))
        metrics = run_shards(bodies)[0].numpy()
        _equal(replicas, optimizers)
        np.testing.assert_allclose(metrics[:3], np.asarray(jax_metrics), rtol=1e-5, atol=1e-6)
        assert metrics[3] == 0
        got = ts.leaves(dump_trees(sac_spec(replicas[0])))
        for path, value in ts.leaves(params).items():
            np.testing.assert_allclose(got[path], np.asarray(value), atol=1e-5, rtol=1e-5, err_msg=path)
        spec = sac_spec(replicas[0])
        specs = {"actor": spec["actor"], "critic": spec["critic"], "alpha": spec["log_alpha"]}
        for name, opt in optimizers[0].items():
            ours = optax_state(opt, specs[name], clip=False)[0]
            assert int(ours[0].fields[0]) == int(opt_states[name][0].count)
            ts.check_moments(ours, opt_states[name])


def _sac_ae(setups, monkeypatch):
    import test_torch_sac_ae as te
    from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_train_step

    # the vector branch (the one-device test's tight tolerances)
    s = setups("sac_ae", lambda: te.Setup(te.TINY + te.VECTOR))
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_make_train_step(s.encoder_def, s.decoder_def, s.actor_def, s.critic_def, s.jax_optimizers(),
                                        s.jax_cfg, s.target_entropy, mesh=_mesh())
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    opt_states, jax_counter, counter = s.jax_init(params), jnp.int32(0), 0
    family = te._Family(s, s.params)
    family.make_update()
    shards = [family, family.replica(CPU[1])]
    for call in range(2):
        seed = 10 + 10 * call
        parts = [te._data(seed + 100 * d) for d in range(SHARDS)]
        data = {k: np.concatenate([p[k] for p in parts], 1) for k in parts[0]}
        keys = jax.random.split(jax.random.PRNGKey(seed + 7), te.G)
        params, opt_states, jax_counter, jax_metrics = s.dp_step(
            params, opt_states, jax_counter, jax.tree_util.tree_map(jnp.asarray, data), keys)
        outs = run_shards([shard.update.body(_torch_rows(p), te._noise(jnp.stack([jax.random.fold_in(k, d) for k in keys]),
                                                                   p), counter)
                           for d, (shard, p) in enumerate(zip(shards, parts))])
        metrics, counter = outs[0]
        assert counter == int(jax_counter)
        _equal([sh.modules() for sh in shards], [sh.optimizers for sh in shards])
        np.testing.assert_allclose(metrics.numpy()[:4], np.asarray(jax_metrics), rtol=1e-5, atol=1e-6)
        assert metrics[4] == 0 and metrics[3] > 0
        # the parameters: the one-device vector test's 2e-5, but for an
        # element whose mean gradient is a rounding error: at these seeds
        # the critic step's gradient of one encoder weight is -6.8e-8 on
        # shard 0 and 0 on shard 1, so Adam (eps 1e-8) moves it by a part
        # of its step that rounding decides, as the one-device pixel test
        # sets out; such an element (one in a hundred of a leaf at most)
        # stays within one Adam step (lr 1e-3, that test's bound)
        got = te.leaves(te.dump_trees(te.sac_ae_spec(family.agent)))
        for path, value in te.leaves(params).items():
            value = np.asarray(value)
            off = np.abs(got[path] - value) > 2e-5 + 1e-5 * np.abs(value)
            assert off.sum() <= max(1, off.size // 100), path
            np.testing.assert_allclose(got[path], value, atol=1e-3, rtol=0, err_msg=path)
        ours = family.opt_states()
        for name in te.NAMES:
            assert int(ours[name][0].fields[0]) == int(opt_states[name][0].count), name
            te.check_moments(ours[name], opt_states[name])


FAMILIES = {"dreamer_v3": _dreamer_v3, "ppo": _ppo, "a2c": _a2c, "ppo_recurrent": _ppo_recurrent, "sac": _sac,
            "droq": _droq, "sac_ae": _sac_ae}


@pytest.fixture(scope="module")
def setups():
    """Each family's setup (its JAX agent jitted once, its two-device step
    compiled once), built at its first use."""
    built = {}

    def get(name, make):
        if name not in built:
            built[name] = make()
        return built[name]

    return get


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_shard_steps_match_the_jax_step_on_two_devices(family, setups, monkeypatch):
    assert len(jax.devices()) >= SHARDS
    FAMILIES[family](setups, monkeypatch)
