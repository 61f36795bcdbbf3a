"""The port's A2C held to the JAX package's on the CPU at a test width (an
MLP of 8 units on the dummy env's ``state``): optax's ``rmsprop`` (eps
inside the square root, a momentum trace) over several steps with and
without the global-norm clip, its state in optax's layout both ways; the
losses; two whole-batch updates against the JAX ``make_train_step`` with
the health stats, for the discrete and multi-discrete families; the
checkpoints both ways, resume, ``eval``, the stateless serving handle and
``serve``; ``run`` on the CPU; and ``instantiate`` refusing the optax
optimizers the port does not have.

Tolerances: the optimizer 1e-6 (the same fp32 arithmetic; the parameters
come out equal); losses and forward outputs 1e-5; after an update,
parameters 1e-5 and the RMSprop state 1e-4 of each tree's scale (it
divides by a root of a small second moment, which magnifies the order
differences of the gradients), the health stats as PPO's.  The JAX
package's continuous log-prob is ``[N]`` against ``[N, 1]`` advantages
(``sheeprl_tpu/algos/a2c/loss.py``: the product broadcasts to ``[N, N]``;
ROADMAP.md Queue 3), so the update parity runs the discrete families."""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sheeprl_tpu.algos.a2c import loss as jax_loss
from sheeprl_tpu.algos.a2c.a2c import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.a2c.agent import build_agent as jax_build_agent
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.a2c import loss
from sheeprl_tpu_torch.algos.a2c.a2c import make_train_step
from sheeprl_tpu_torch.algos.a2c.agent import build_agent
from sheeprl_tpu_torch.config import CONFIG_DIR, compose, instantiate
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_params import _walk, optax_state, optimizer_state_dict, ppo_spec, ppo_to_flax
from sheeprl_tpu_torch.utils.checkpoint import load_state
from sheeprl_tpu_torch.utils.optim import RMSprop, rmsprop
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["exp=a2c", "env=dummy", "env.capture_video=False", "algo.dense_units=8", "algo.mlp_layers=2",
        "algo.encoder.mlp_features_dim=6", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]",
        "diagnostics.health.per_module=True", "seed=3"]
FAMILIES = {"discrete": ((2,), []), "multidiscrete": ((2, 2), ["algo.max_grad_norm=0.5",
                                                                "algo.normalize_advantages=True",
                                                                "algo.loss_reduction=mean"])}
GYM_OBS = gym.spaces.Dict({"state": gym.spaces.Box(-20, 20, (10,), np.float32)})
OBS_SPACE = spaces.Dict({"state": spaces.Box(-20, 20, (10,), np.float32)})


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


class _Setup:
    """One family's JAX A2C agent (params jitted, then perturbed) and the
    port's agent on the converted params."""

    def __init__(self, family, extra=()):
        self.actions_dim, options = FAMILIES[family]
        overrides = TINY + options + list(extra)
        self.cfg, self.jax_cfg = compose(overrides), jax_compose(overrides)
        holder = []

        def init():
            agent, params, _ = jax_build_agent(None, self.actions_dim, False, self.jax_cfg, GYM_OBS)
            holder.append(agent)
            return params

        params = jax.tree_util.tree_map(np.asarray, jax.jit(init)())
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params)
        self.jax_agent = holder[0]

    def agent(self, params=None):
        return build_agent(self.actions_dim, False, self.cfg, OBS_SPACE, self.params if params is None else params,
                           "cpu")

    def jax_optimizer(self):
        chain = [optax.clip_by_global_norm(self.jax_cfg.algo.max_grad_norm)] if self.jax_cfg.algo.max_grad_norm else []
        return optax.chain(*chain, jax_instantiate(self.jax_cfg.algo.optimizer))


@pytest.fixture(scope="module")
def disc():
    return _Setup("discrete")


@pytest.mark.parametrize("clip,momentum", [(False, 0.0), (True, 0.0), (False, None), (True, 0.9)])
def test_rmsprop_matches_optax_over_several_steps_with_its_state_in_optax_layout(disc, clip, momentum):
    """Five steps of random gradients through optax's ``chain([clip,]
    rmsprop)`` and the port's ``RMSprop`` on the agent's parameters: the
    parameters, then the state as ``optax_state`` writes it (the optax
    classes and tree of ``init``) and as ``optimizer_state_dict`` reads the
    JAX package's back."""
    kwargs = dict(learning_rate=7e-4, decay=0.99, eps=1e-5, momentum=momentum)
    tx = optax.chain(*([optax.clip_by_global_norm(0.5)] if clip else []), optax.rmsprop(**kwargs))
    params = jax.tree_util.tree_map(jnp.asarray, disc.params)
    state = tx.init(params)
    agent = disc.agent()
    opt = rmsprop(**kwargs)(agent.parameters())
    spec = ppo_spec(agent)
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), disc.params)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        flat = list(_walk(spec, grads, "", {}))
        g_norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for _, v in flat))
        for tensor, value in flat:
            g = torch.from_numpy(value)
            tensor.grad = g * (0.5 / np.float32(g_norm)) if clip and g_norm >= 0.5 else g
        opt.step()
        opt.zero_grad(set_to_none=True)
    got, want = _leaves(ppo_to_flax(agent)), _leaves(params)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=1e-6, rtol=1e-6, err_msg=path)

    ours = optax_state(opt, spec, clip=clip)
    names = [type(s).__name__ for s in jax.tree_util.tree_leaves(ours, is_leaf=lambda x: hasattr(x, "fields"))]
    want_names = [type(s).__name__ for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, tuple) and hasattr(x, "_fields"))]
    assert names == want_names
    (rms, _, trace) = ours[-1]
    (jrms, _, jtrace) = state[-1]
    pairs = [(rms.fields[0], jrms.nu)] + ([(trace.fields[0], jtrace.trace)] if momentum is not None else [])
    for mine, theirs in pairs:
        mine, theirs = _leaves(mine), _leaves(theirs)
        assert sorted(mine) == sorted(theirs)
        for path in theirs:
            np.testing.assert_allclose(mine[path], theirs[path], atol=1e-6, rtol=1e-6, err_msg=path)
    # the JAX package's state into a fresh optimizer: the same tensors
    other = disc.agent()
    fresh = rmsprop(**kwargs)(other.parameters())
    fresh.load_state_dict(optimizer_state_dict(jax.tree_util.tree_map(np.asarray, state), fresh, ppo_spec(other)))
    for a, b in zip(fresh.state.values(), opt.state.values()):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6, rtol=1e-6)


def test_rmsprop_is_not_torch_rmsprop():
    """optax puts eps inside the root: one step from ``nu = 0`` moves a
    parameter by ``lr * g / sqrt((1 - decay) g^2 + eps)``."""
    p = torch.nn.Parameter(torch.tensor([1.0]))
    opt = RMSprop([p], lr=0.1, decay=0.99, eps=1.0)
    p.grad = torch.tensor([1.0])
    opt.step()
    torch.testing.assert_close(p.detach(), torch.tensor([1.0 - 0.1 / np.sqrt(0.01 + 1.0)], dtype=torch.float32),
                               rtol=0, atol=1e-7)
    q = torch.nn.Parameter(torch.tensor([1.0]))
    torch_opt = torch.optim.RMSprop([q], lr=0.1, alpha=0.99, eps=1.0)
    q.grad = torch.tensor([1.0])
    torch_opt.step()
    assert abs(q.item() - p.item()) > 1e-3  # eps outside the root: 1 - 0.1 / (0.1 + 1)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", "Sum"])
def test_losses_match_jax(reduction):
    rng = np.random.default_rng(4)
    logprobs, advantages, values, returns = (rng.normal(size=(6, 1)).astype(np.float32) for _ in range(4))
    for mine, theirs in ((loss.policy_loss(torch.from_numpy(logprobs), torch.from_numpy(advantages), reduction),
                          jax_loss.policy_loss(logprobs, advantages, reduction)),
                         (loss.value_loss(torch.from_numpy(values), torch.from_numpy(returns), reduction),
                          jax_loss.value_loss(values, returns, reduction))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="Unrecognized reduction"):
        loss.value_loss(torch.zeros(2), torch.zeros(2), "max")


class _Mesh:
    devices = np.zeros(1)


def _data(n, s, seed):
    rng = np.random.default_rng(seed)
    col = lambda: rng.normal(size=(n, 1)).astype(np.float32)  # noqa: E731
    actions = np.stack([rng.integers(0, d, n) for d in s.actions_dim], -1).astype(np.float32)
    return {"obs": {"state": rng.normal(size=(n, 10)).astype(np.float32)}, "actions": actions, "returns": col(),
            "advantages": col()}


def _torch(data):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in data.items()}


def _check_update(s, out, agent, optimizer, metrics, health_names, clip):
    params, opt_state, jax_metrics, jax_health = jax.tree_util.tree_map(np.asarray, out)
    np.testing.assert_allclose(metrics[:4].numpy(), jax_metrics, atol=1e-5, rtol=1e-5)
    health = dict(zip(health_names, metrics[4:].numpy()))
    assert sorted(health) == sorted(jax_health) and "value_ev" in health and "module/critic/update_ratio" in health
    for k, v in jax_health.items():
        tol = 1e-6 if k.endswith("dead_frac") else 1e-4
        np.testing.assert_allclose(health[k], float(v), rtol=tol, atol=tol / 10, err_msg=k)
    got = _leaves(ppo_to_flax(agent))
    for p, value in _leaves(params).items():
        np.testing.assert_allclose(got[p], value, atol=1e-5, rtol=1e-5, err_msg=p)
    ours, theirs = optax_state(optimizer, ppo_spec(agent), clip=clip)[-1], opt_state[-1]
    for mine, want in ((ours[0].fields[0], theirs[0].nu), (ours[2].fields[0], theirs[2].trace)):
        mine, want = _leaves(mine), _leaves(want)
        scale = max(float(np.abs(v).max()) for v in want.values())
        for p in want:
            np.testing.assert_allclose(mine[p], want[p], atol=1e-4 * scale, rtol=1e-3, err_msg=p)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_updates_match_the_jax_train_step(family):
    """Two consecutive whole-batch updates from converted params: the four
    metrics, the health stats per module with ``value_ev``, the parameters
    and RMSprop's state.  ``discrete``: the defaults (``loss_reduction:
    sum``, no clip); ``multidiscrete``: the clip, normalized advantages and
    ``mean``."""
    s = _Setup(family)
    tx = s.jax_optimizer()
    jax_step = jax_make_train_step(s.jax_agent, tx, s.jax_cfg, _Mesh())
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    opt_state = tx.init(params)
    agent = s.agent()
    optimizer = instantiate(s.cfg.algo.optimizer)(agent.parameters())
    assert isinstance(optimizer, RMSprop)
    step = make_train_step(agent, optimizer, s.cfg)
    for it in range(2):
        data = _data(8, s, 10 + it)
        out = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data))
        params, opt_state = out[0], out[1]
        metrics = step(_torch(data))
        _check_update(s, out, agent, optimizer, metrics, step.health_names, bool(s.cfg.algo.max_grad_norm))


@pytest.mark.parametrize("precision", ["bf16-mixed", "bf16-true"])
def test_two_updates_match_the_jax_train_step_in_bf16(precision):
    """Two whole-batch updates under ``precision`` (the multi-discrete
    family: the clip, normalized advantages): the agent and the
    observations cast to bf16 in the loss, as the JAX loss casts them, and
    under ``bf16-true`` the weights and RMSprop's state stored in bf16.  The
    losses within 2^-6 of their scale (a few bf16 steps), the parameters
    within 4 bf16 steps of each tree's scale."""
    s = _Setup("multidiscrete", [f"fabric.precision={precision}"])
    true = precision == "bf16-true"
    dtype = jnp.bfloat16 if true else jnp.float32
    tx = s.jax_optimizer()
    jax_step = jax_make_train_step(s.jax_agent, tx, s.jax_cfg, _Mesh())
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), s.params)
    opt_state = tx.init(params)
    agent = s.agent(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params))
    agent.to(torch.bfloat16 if true else torch.float32)
    optimizer = instantiate(s.cfg.algo.optimizer)(agent.parameters())
    step = make_train_step(agent, optimizer, s.cfg)
    for it in range(2):
        data = _data(8, s, 50 + it)
        params, opt_state, want, _ = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data))
        metrics = step(_torch(data)).numpy()
        want = np.asarray(want)
        assert np.isfinite(metrics).all() and metrics[3] == want[3] == 0
        np.testing.assert_allclose(metrics[:2], want[:2], rtol=0, atol=2**-6 * max(1.0, np.abs(want[:2]).max()))
    assert all(p.dtype == (torch.bfloat16 if true else torch.float32) for p in agent.parameters())
    assert all(v.dtype == (torch.bfloat16 if true else torch.float32) for e in optimizer.state.values()
               for v in e.values())
    got = _leaves(ppo_to_flax(agent))
    for path, value in _leaves(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)).items():
        scale = max(float(np.abs(value).max()), 1e-3)
        np.testing.assert_allclose(got[path], value, rtol=0, atol=4 * 2**-8 * scale, err_msg=path)


RUN = TINY + ["fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=4", "algo.per_rank_batch_size=4",
              "algo.total_steps=16", "metric.logger=null", "metric.log_every=8", "buffer.memmap=False",
              "checkpoint.every=8", "env.id=discrete_dummy"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port A2C run on the CPU: 2 iterations, a checkpoint after each."""
    out = cli.run(RUN + [f"root_dir={tmp_path_factory.mktemp('a2c_port')}"])
    assert len(out["checkpoints"]) == 2 and out["updates_per_iteration"] == 1
    return out


def _one_update_each(ckpt, s):
    """One checkpoint restored as each package's loop restores it (the
    agent, the optax state into ``init``'s tree), then one update each."""
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    jax_state, state = jax_load_state(ckpt), load_state(ckpt)
    params = jax.tree_util.tree_map(jnp.asarray, jax_state["agent"])
    tx = s.jax_optimizer()
    opt_state = jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=getattr(ref, "dtype", None)),
                                       tx.init(params), jax_state["opt_state"])
    agent = s.agent(state["agent"])
    optimizer = instantiate(s.cfg.algo.optimizer)(agent.parameters())
    optimizer.load_state_dict(optimizer_state_dict(state["opt_state"], optimizer, ppo_spec(agent)))
    step = make_train_step(agent, optimizer, s.cfg)
    data = _data(8, s, 30)
    out = jax_step_of(s, tx)(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data))
    _check_update(s, out, agent, optimizer, step(_torch(data)), step.health_names, False)


def jax_step_of(s, tx):
    return jax_make_train_step(s.jax_agent, tx, s.jax_cfg, _Mesh())


def test_a_port_checkpoint_verifies_and_resumes_in_the_jax_package(port_run, disc):
    """The JAX ``verify_checkpoint`` accepts the port's manifest; the JAX
    loop's restore reads the agent and optax's ``rmsprop`` state, and its
    next update matches the port's from the same checkpoint."""
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint

    ckpt = port_run["checkpoints"][0]
    assert jax_verify_checkpoint(ckpt) == (True, "verified")
    saved = load_state(ckpt)["opt_state"]
    assert [type(x).__name__ for x in saved[0]] == ["ScaleByRmsState", "EmptyState", "TraceState"]
    _one_update_each(ckpt, disc)


def test_a_jax_checkpoint_resumes_and_evaluates_in_the_port(tmp_path, monkeypatch, disc):
    """The JAX package's A2C run writes a checkpoint; the port's next update
    from it matches the JAX one, ``run`` resumes from it and trains on, and
    ``eval`` scores it."""
    from sheeprl_tpu.cli import run as jax_run

    monkeypatch.chdir(tmp_path)
    jax_run(RUN + ["root_dir=jax_a2c"])
    ckpts = sorted(tmp_path.rglob("*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [int(p.name.split("_")[1]) for p in ckpts] == [8, 16]
    _one_update_each(str(ckpts[0]), disc)
    out = cli.run(RUN + [f"checkpoint.resume_from={ckpts[0]}"])
    assert out["start_iter"] == 2 and out["iterations"] == 1 and out["policy_steps"] == 16
    assert np.isfinite(out["metric_rows"]).all()
    assert np.isfinite(cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"]))


def test_run_trains_logs_evaluates_and_refuses_what_it_does_not_port(port_run, tmp_path):
    assert port_run["metric_rows"].shape == (2, 3) and np.isfinite(port_run["metric_rows"]).all()
    assert port_run["nonfinite_updates"].tolist() == [0.0, 0.0]
    assert port_run["health_rows"]["value_ev"].shape == (2,)
    for logged in port_run["logged"]:
        assert logged["Time/sps_env_interaction"] > 0 and logged["Time/sps_train"] > 0
        assert np.isfinite([logged[k] for k in ("Loss/policy_loss", "Loss/value_loss", "Grads/global_norm")]).all()
    assert np.isfinite(cli.evaluation([f"checkpoint_path={port_run['checkpoints'][-1]}", "fabric.accelerator=cpu"]))
    with pytest.raises(NotImplementedError, match="metric.profiler.enabled"):
        cli.run(RUN + ["metric.profiler.enabled=True", f"root_dir={tmp_path}"])
    with pytest.raises(ValueError, match="vector observations"):
        cli.run(RUN + ["algo.cnn_keys.encoder=[rgb]", f"root_dir={tmp_path}"])


def test_serving_handle_acts_as_the_jax_handle(disc):
    from sheeprl_tpu.serving.loader import _ppo_like_handle
    from sheeprl_tpu_torch.serving.loader import build_policy

    jax_handle = _ppo_like_handle(disc.jax_cfg, GYM_OBS, gym.spaces.Discrete(2), disc.params)
    handle = build_policy(disc.cfg, OBS_SPACE, spaces.Discrete(2), disc.params, "cpu")
    assert handle.algo == jax_handle.algo == "a2c" and not handle.stateful
    assert handle.obs_spec == jax_handle.obs_spec and handle.action_shape == jax_handle.action_shape
    rng = np.random.default_rng(5)
    obs = handle.assemble([handle.validate({"state": rng.normal(size=10)}) for _ in range(3)], 4)
    want = np.asarray(jax.jit(jax_handle.make_step(True))(disc.params, obs, jax.random.PRNGKey(0)))
    got = handle.make_step(True)(handle.params, {k: torch.from_numpy(v) for k, v in obs.items()}, None).numpy()
    np.testing.assert_array_equal(got, want)


def test_serve_answers_a_port_checkpoint_over_http(port_run):
    import json
    import threading
    import urllib.request

    from sheeprl_tpu_torch.serving.server import ServeApp

    cfg, path, device = cli.serve_config([f"checkpoint_path={port_run['checkpoints'][-1]}", "fabric.accelerator=cpu",
                                          "serving.batch_buckets=[4]"])
    app = ServeApp(cfg, path, device)
    host, port = app.start()
    replies = []

    def client(i):
        body = json.dumps({"obs": {"state": [float(i)] * 10}, "greedy": i % 2 == 0}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/act", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            replies.append((resp.status, json.loads(resp.read())))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert len(replies) == 6 and all(status == 200 for status, _ in replies)
        assert all(np.asarray(body["action"]).shape == (1,) and body["action"][0] in (0, 1) for _, body in replies)
    finally:
        app.close()


def test_instantiate_maps_optax_rmsprop_and_refuses_the_other_optax_targets():
    def node(name):
        return yaml.safe_load((CONFIG_DIR / "optim" / f"{name}.yaml").read_text())

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        instantiate(node("sgd"))
    assert isinstance(instantiate(node("adamw"))([torch.nn.Parameter(torch.zeros(2))]), torch.optim.AdamW)
    with pytest.raises(NotImplementedError, match="centered=True"):
        instantiate({**node("rmsprop"), "centered": True})
    # the JAX package's archived target, and the TF-semantics preset (optax's
    # rmsprop with eps inside the root), build the port's RMSprop
    for cfg in ({**node("rmsprop"), "_target_": "optax.rmsprop"}, node("rmsprop_tf")):
        assert isinstance(instantiate(cfg)([torch.nn.Parameter(torch.zeros(2))]), RMSprop)
