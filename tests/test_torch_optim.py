"""The port's optimizer targets against optax on the CPU: ``sgd`` (with
``momentum`` and ``nesterov``), ``rmsprop``'s ``centered``, ``nesterov``,
``bias_correction`` and ``eps_in_sqrt=False``, ``adamw``'s ``mask``,
``nesterov``, ``mu_dtype`` and ``eps_root``, and ``adam``'s ``eps_root``
(``sheeprl_tpu_torch/utils/optim.py``).  Each variant's update and state
against optax's for three steps, its state through the converter
(``interop/flax_params.py``) both ways; a PPO run with ``optim=sgd`` and an
A2C run with a centered ``rmsprop``, whose checkpoints the JAX
``verify_checkpoint`` accepts and whose next update matches the JAX loop's
from the same checkpoint.

Tolerances: float32 updates relative 1e-6 (the same arithmetic in the same
order; a bias correction's power may differ by one unit in the last place);
the runs' updates as the PPO and A2C parity tests hold them (1e-5)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import CONFIG_DIR, instantiate
from sheeprl_tpu_torch.interop.flax_params import optax_state, optimizer_state_dict, ppo_spec, ppo_to_flax
from sheeprl_tpu_torch.utils import optim
from sheeprl_tpu_torch.utils.checkpoint import OptaxState, load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

LR = 0.01
# (optax's keys, the extra optax call arguments that a config cannot spell)
VARIANTS = {
    "sgd": ("sgd", {}),
    "sgd_momentum": ("sgd", {"momentum": 0.9}),
    "sgd_nesterov": ("sgd", {"momentum": 0.9, "nesterov": True}),
    "rmsprop_centered": ("rmsprop", {"centered": True}),
    "rmsprop_nesterov": ("rmsprop", {"momentum": 0.9, "nesterov": True}),
    "rmsprop_bias_correction": ("rmsprop", {"bias_correction": True}),
    "rmsprop_eps_outside": ("rmsprop", {"eps_in_sqrt": False}),
    # centered with bias_correction is optax's own 0/0 at the first step
    # (both moments corrected to g**2): the options are held apart
    "rmsprop_all": ("rmsprop", {"centered": True, "momentum": 0.9, "nesterov": True, "eps_in_sqrt": False,
                                "initial_scale": 0.1}),
    "adam_eps_root": ("adam", {"eps_root": 1e-8}),
    "adamw_mask": ("adamw", {"weight_decay": 0.1, "mask": "W"}),
    "adamw_nesterov": ("adamw", {"nesterov": True}),
    "adamw_mu_dtype": ("adamw", {"mu_dtype": "bfloat16"}),
    "adamw_eps_root": ("adamw", {"eps_root": 1e-8, "weight_decay": 0.1}),
}


def _tree():
    rng = np.random.default_rng(0)
    params = {"W": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()} for _ in range(4)]
    return params, grads


def _pair(variant: str, params):
    """optax's transform and the port's optimizer over ``params``, with the
    port's spec of them (the flax layout is the tree itself)."""
    name, kw = VARIANTS[variant]
    jax_kw, port_kw = dict(kw), dict(kw)
    if "mask" in kw:  # only the named leaf decays: a tree for optax, one bool a tensor here
        jax_kw["mask"] = {k: k == kw["mask"] for k in params}
        port_kw["mask"] = [k == kw["mask"] for k in params]
    if "mu_dtype" in kw:
        jax_kw["mu_dtype"] = getattr(jnp, kw["mu_dtype"])
    tx = getattr(optax, name)(LR, **jax_kw)
    tensors = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = getattr(optim, name)(LR, **port_kw)(list(tensors.values()))
    return tx, opt, tensors, {k: (t, "same") for k, t in tensors.items()}


def _norm(node):
    """An optax state (optax's classes or the port's stand-ins) as nested
    ``(class name, fields)`` with float32 numpy leaves."""
    if isinstance(node, OptaxState):
        return type(node).__name__, tuple(_norm(f) for f in node.fields)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node).__name__, tuple(_norm(f) for f in node)
    if isinstance(node, (tuple, list)):
        return "tuple", tuple(_norm(f) for f in node)
    if isinstance(node, dict):
        return f"dict{sorted(node)}", tuple(_norm(v) for _, v in sorted(node.items()))
    return np.asarray(node, np.float32)


def _assert_same(got, want, path="", rtol=1e-6, atol=1e-9):
    """The same classes and fields, leaves within ``rtol`` and ``atol``
    times the leaf's largest magnitude (at least ``atol``)."""
    if isinstance(want, np.ndarray):
        scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=path)
        return
    assert got[0] == want[0] and len(got[1]) == len(want[1]), (path, got[0], want[0])
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        _assert_same(g, w, f"{path}/{want[0]}[{i}]", rtol, atol)


def _step(opt, tensors, grads):
    for k, t in tensors.items():
        t.grad = torch.tensor(grads[k])
    opt.step()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_update_and_state_match_optax_for_three_steps_and_cross_the_converter(variant):
    params, grads = _tree()
    tx, opt, tensors, spec = _pair(variant, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    type_name = type(opt).__name__
    assert type_name in ("SGD", "RMSprop", "OptaxAdam"), type_name  # optax's update written out
    for g in grads[:3]:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _step(opt, tensors, g)
        for k in params:
            assert np.isfinite(np.asarray(jparams[k])).all(), k
            np.testing.assert_allclose(tensors[k].detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-9,
                                       err_msg=k)
    # port -> optax: the chain's state, class for class and leaf for leaf
    _assert_same(_norm(optax_state(opt, spec, clip=False)[0]), _norm(state))
    # optax -> port: a fresh optimizer restored from optax's state takes
    # optax's fourth step
    _, fresh, fresh_tensors, fresh_spec = _pair(variant, {k: np.asarray(v) for k, v in jparams.items()})
    fresh.load_state_dict(optimizer_state_dict((state,), fresh, fresh_spec))
    updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads[3]), state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    _step(fresh, fresh_tensors, grads[3])
    for k in params:
        np.testing.assert_allclose(fresh_tensors[k].detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_the_defaults_stay_torch_adam(name):
    """At optax's defaults of the options above, ``adam`` and ``adamw`` are
    ``torch.optim.Adam`` / ``AdamW``, whose updates are optax's."""
    cls = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW}[name]
    assert type(getattr(optim, name)(LR)([torch.nn.Parameter(torch.zeros(2))])) is cls


def test_every_optim_config_instantiates_and_the_jax_targets_map():
    """Every ``configs/optim`` file, and the JAX package's archived
    ``optax.*`` target of each, builds the port's optimizer."""
    for path in sorted((CONFIG_DIR / "optim").glob("*.yaml")):
        node = yaml.safe_load(path.read_text())
        jax_target = "optax." + node["_target_"].rsplit(".", 1)[-1]
        for cfg in (node, {**node, "_target_": jax_target}):
            opt = instantiate(cfg)([torch.nn.Parameter(torch.zeros(2))])
            assert isinstance(opt, torch.optim.Optimizer), path.name


# ---------------------------------------------------------------------------
# the loops: PPO with optim=sgd, A2C with a centered rmsprop
# ---------------------------------------------------------------------------


def _run_and_restore(tmp_path_factory, module: str, overrides):
    """A port run of ``module``'s tiny RUN with ``overrides`` (2 iterations,
    a checkpoint after each), its first checkpoint verified by the JAX
    package, and both packages' restores of it."""
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    test = pytest.importorskip(module)
    out = cli.run(test.RUN + overrides + [f"root_dir={tmp_path_factory.mktemp(module)}"])
    assert len(out["checkpoints"]) == 2 and np.isfinite(out["metric_rows"]).all()
    ckpt = out["checkpoints"][0]
    assert jax_verify_checkpoint(ckpt) == (True, "verified")
    return test, jax_load_state(ckpt), load_state(ckpt)


def _jax_restore(jax_state, tx):
    """The JAX loops' restore: the saved optax state into ``tx.init``'s tree."""
    params = jax.tree_util.tree_map(jnp.asarray, jax_state["agent"])
    opt_state = jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=getattr(ref, "dtype", None)),
                                       tx.init(params), jax_state["opt_state"])
    return params, opt_state


def _assert_params(agent, params):
    got = _leaves(ppo_to_flax(agent))
    for path, value in _leaves(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(got[path], value, atol=1e-5, rtol=1e-5, err_msg=path)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}": np.asarray(v)})
    return out


def test_a_ppo_run_with_sgd_resumes_in_the_jax_loop(tmp_path_factory):
    """optax's ``sgd`` (momentum 0.9) under PPO's ``anneal_lr`` schedule:
    the checkpoint holds optax's ``(clip, (TraceState,
    ScaleByScheduleState))`` chain, the JAX loop restores it, and the JAX
    update from it matches the port's."""
    overrides = ["algo.optimizer={_target_: optax.sgd, learning_rate: 0.001, momentum: 0.9}"]
    test, jax_state, state = _run_and_restore(tmp_path_factory, "test_torch_ppo", overrides)
    trace, schedule = state["opt_state"][1]
    assert (type(trace).__name__, type(schedule).__name__) == ("TraceState", "ScaleByScheduleState")
    assert int(np.asarray(schedule[0])) == test.RUN_UPDATES // 2  # one iteration's updates
    s = test._Setup("multidiscrete_dummy", overrides)
    tx = test._jax_optimizer(s.jax_cfg, test.RUN_UPDATES)
    params, opt_state = _jax_restore(jax_state, tx)
    jax_step = test.jax_make_train_step(s.jax_agent, tx, s.jax_cfg, test._Mesh(), 2, 4)
    agent, optimizer, step = test._port_update(s, state["agent"], state["opt_state"], test.RUN_UPDATES, 2)
    assert type(optimizer).__name__ == "SGD"
    data = test._data(8, s, 30)
    key = jax.random.PRNGKey(31)
    coefs = (0.2, 0.01, 0.5)
    out = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data), key,
                   tuple(jnp.float32(c) for c in coefs))
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, 8))) for k in jax.random.split(key, 2)]
    metrics = step(_torch(data), perms, coefs)
    np.testing.assert_allclose(metrics[:5].numpy(), np.asarray(out[2]), atol=1e-5, rtol=1e-5)
    _assert_params(agent, out[0])
    # the state after a whole update: the parity tests' tolerance
    _assert_same(_norm(optax_state(optimizer, ppo_spec(agent), clip=True, schedule=True)), _norm(out[1]),
                 rtol=1e-3, atol=1e-4)


def _torch(data):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in data.items()}


def test_an_a2c_run_with_a_centered_rmsprop_resumes_in_the_jax_loop(tmp_path_factory):
    """A2C with ``rmsprop`` centered and bias-corrected: the checkpoint
    holds ``ScaleByRStdDevWithCountState(count, mu, nu)``, the JAX loop
    restores it, and the JAX update from it matches the port's."""
    overrides = ["algo.optimizer.centered=True", "algo.optimizer.bias_correction=True"]
    test, jax_state, state = _run_and_restore(tmp_path_factory, "test_torch_a2c", overrides)
    rms = state["opt_state"][0][0]
    assert type(rms).__name__ == "ScaleByRStdDevWithCountState" and int(np.asarray(rms[0])) == 1  # one update
    s = test._Setup("discrete", overrides)
    tx = s.jax_optimizer()
    params, opt_state = _jax_restore(jax_state, tx)
    agent = s.agent(state["agent"])
    optimizer = instantiate(s.cfg.algo.optimizer)(agent.parameters())
    optimizer.load_state_dict(optimizer_state_dict(state["opt_state"], optimizer, ppo_spec(agent)))
    step = test.make_train_step(agent, optimizer, s.cfg)
    data = test._data(8, s, 30)
    out = test.jax_step_of(s, tx)(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data))
    metrics = step(_torch(data))
    np.testing.assert_allclose(metrics[:4].numpy(), np.asarray(out[2]), atol=1e-5, rtol=1e-5)
    _assert_params(agent, out[0])
    _assert_same(_norm(optax_state(optimizer, ppo_spec(agent), clip=bool(s.cfg.algo.max_grad_norm))),
                 _norm(out[1]), rtol=1e-3, atol=1e-4)
