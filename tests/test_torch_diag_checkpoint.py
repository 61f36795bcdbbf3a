"""The port's checkpoints read by the JAX package, on the CPU at a test
width: the manifest sidecar that the JAX ``verify_checkpoint`` calls
``verified`` (and a flipped byte ``digest_mismatch``), written with
diagnostics on and off; ``opt_states`` in optax's layout, which the JAX
``load_state`` reads into the tree of ``optimizer.init(params)``; the JAX
``make_train_step`` resuming from that state and matching the port's next
step (the injected-noise parity of ``test_torch_dv3_train.py``), its health
stats included."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.ops import distributions as jax_distributions
from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, TRAINED, make_optimizers, make_train_step
from sheeprl_tpu_torch.interop.flax_params import to_flax
from sheeprl_tpu_torch.resilience.manifest import read_manifest, verify_checkpoint
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_dv3_train import OBS_SPACE, RUN, _adam_moments, _batch, _jax_noise, _leaves, _record_margins, _Setup
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

# the run of the `disc` setup's config (multi-discrete actions), training
# from iteration 4 and checkpointing at its end
DISC_RUN = [o for o in RUN if not o.startswith("env.id")] + ["env.id=multidiscrete_dummy"]


@pytest.fixture(scope="module")
def disc():
    return _Setup("multidiscrete_dummy", (2, 2), False)


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """A port run's last checkpoint, written under the default diagnostics
    (through the async writer)."""
    root = tmp_path_factory.mktemp("port_run")
    out = cli.run([o for o in DISC_RUN if o != "diagnostics=off"] + [f"root_dir={root}"])
    assert out["gradient_steps"] > 0
    return out["checkpoints"][-1]


@pytest.mark.parametrize("diagnostics", ["default", "off"])
def test_jax_verifies_a_port_checkpoint_by_its_manifest(tmp_path, monkeypatch, diagnostics):
    monkeypatch.chdir(tmp_path)
    out = cli.run([o for o in RUN if o != "diagnostics=off"] + [f"diagnostics={diagnostics}", "checkpoint.every=8"])
    assert len(out["checkpoints"]) == 2
    for ckpt in out["checkpoints"]:
        manifest = read_manifest(ckpt)
        assert manifest["fingerprint"].startswith("sheeprl_tpu_torch-") and manifest["step"] > 0
        assert "opt_states.world_model[1][0][0]" in manifest["tree"]  # ScaleByAdamState.count
        assert jax_verify_checkpoint(ckpt) == verify_checkpoint(ckpt) == (True, "verified")
    ckpt = out["checkpoints"][-1]
    data = bytearray(open(ckpt, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(ckpt, "wb").write(bytes(data))
    assert jax_verify_checkpoint(ckpt) == verify_checkpoint(ckpt) == (False, "digest_mismatch")
    assert jax_verify_checkpoint(ckpt, deep=False) == (True, "verified")  # the size still matches


def _jax_optimizers(jax_cfg):
    return {k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients),
                           jax_instantiate(jax_cfg.algo[k].optimizer)) for k in TRAINED}


def test_jax_reads_the_port_optimizer_state_as_optax_init_lays_it_out(disc, port_checkpoint):
    state = jax_load_state(port_checkpoint)
    opts = _jax_optimizers(disc.jax_cfg)
    for name in TRAINED:
        params = jax.tree_util.tree_map(jnp.asarray, state[name])
        init = opts[name].init(params)
        saved = state["opt_states"][name]
        assert jax.tree_util.tree_structure(saved) == jax.tree_util.tree_structure(init)
        assert type(saved[1][0]) is type(init[1][0]) and type(saved[0]) is type(init[0])  # the optax classes
        for a, b in zip(jax.tree_util.tree_leaves(saved), jax.tree_util.tree_leaves(init)):
            assert np.shape(a) == np.shape(b)
        count = int(saved[1][0].count)
        assert count > 0 and np.asarray(saved[1][0].count).dtype == np.int32
    # the port reads its own checkpoint back exactly as it wrote it
    agent = build_agent(disc.actions_dim, False, disc.cfg, OBS_SPACE,
                        {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")}, "cpu")
    optimizers = make_optimizers(disc.cfg, agent)
    dv3.load_learner_state(load_state(port_checkpoint), agent, optimizers, "cpu")
    got = _adam_moments(agent, optimizers)
    for name in TRAINED:
        adam = state["opt_states"][name][1][0]
        for slot, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want = _leaves(tree)
            for path, value in _leaves(got[name][slot]).items():
                np.testing.assert_array_equal(value, want[path], err_msg=f"{name}{path}")
        assert {float(s["step"]) for s in optimizers[name].state.values()} == {float(adam.count)}


def test_jax_resumes_a_port_checkpoint_and_its_next_step_matches_the_ports(disc, port_checkpoint, monkeypatch):
    """From one port checkpoint: the JAX package restores params, optax
    state and Moments as its loop does and takes one step; the port restores
    it as ``run`` does and takes the same step with the same noise.  Both
    with the health stats on, per module."""
    cfg, jax_cfg = copy.deepcopy(disc.cfg), copy.deepcopy(disc.jax_cfg)
    for c in (cfg, jax_cfg):
        c.diagnostics.enabled = True
        c.diagnostics.health.per_module = True
    state = jax_load_state(port_checkpoint)
    opts = _jax_optimizers(jax_cfg)
    params = {k: jax.tree_util.tree_map(jnp.asarray, state[k]) for k in ("world_model", "actor", "critic",
                                                                           "target_critic")}
    # the JAX loop's restore (dreamer_v3.py::_default_make_optimizers)
    opt_states = {k: jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=ref.dtype),
                                            opts[k].init(params[k]), state["opt_states"][k]) for k in TRAINED}
    moments = jax.tree_util.tree_map(jnp.asarray, state["moments"])
    jax_step = jax_make_train_step(disc.wm_def, disc.actor_def, disc.critic_def, opts, jax_cfg, disc.actions_dim, False)

    port_state = load_state(port_checkpoint)
    agent = build_agent(disc.actions_dim, False, cfg, OBS_SPACE,
                        {k: port_state[k] for k in ("world_model", "actor", "critic", "target_critic")}, "cpu")
    optimizers = make_optimizers(cfg, agent)
    moments_state = dv3.load_learner_state(port_state, agent, optimizers, "cpu")
    step = make_train_step(agent, optimizers, cfg, False)
    _record_margins(monkeypatch)

    batch = {k: v.astype(np.float32) for k, v in _batch(disc, 17).items()}
    key = jax.random.PRNGKey(33)
    # the JAX step once more in float64, the reference for the Adam moments
    # below: the actor's gradient is small (first moments ~3e-5 once the run
    # samples its actions) and the jitted float32 step's own rounding there
    # exceeds their tolerance.  Same keys, so same draws: each categorical is
    # drawn on float32 logits, as in the float32 step
    categorical = jax.random.categorical
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_distributions, "_f32", lambda x: x)
        mp.setattr(jax_dv3, "compute_dtype_of", lambda cfg: jnp.float64)
        mp.setattr(jax.random, "categorical",
                   lambda k, logits, **kw: categorical(k, logits.astype(jnp.float32), **kw))
        step64 = jax_make_train_step(disc.wm_def, disc.actor_def, disc.critic_def, opts, jax_cfg, disc.actions_dim,
                                     False)
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda v: jnp.asarray(v, jnp.float64 if np.issubdtype(np.asarray(v).dtype, np.floating) else None),
                tree)

        params64 = {k: f64(state[k]) for k in params}
        opt_states64 = {k: f64(state["opt_states"][k]) for k in TRAINED}
        exact = jax.tree_util.tree_map(np.asarray, step64(
            params64, opt_states64, f64(state["moments"]), {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()},
            key, jnp.float64(0.02))[1])
    params, opt_states, moments, jax_metrics, jax_health = jax_step(
        params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(0.02))
    moments_state, metrics = step(moments_state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.02, None,
                                  _jax_noise(disc, key))
    n = len(METRIC_ORDER)
    np.testing.assert_allclose(metrics[:n].numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4,
                               err_msg=str(METRIC_ORDER))
    health = dict(zip(step.health_names, metrics[n:].numpy()))
    assert sorted(health) == sorted(jax_health) and "module/critic/update_ratio" in health
    for k, v in jax_health.items():
        if k.endswith("dead_frac"):
            assert health[k] == float(v), k
        else:
            # the gradient norms' tolerance (the actor's gradient is small)
            np.testing.assert_allclose(health[k], float(v), rtol=1e-4, atol=1e-4 * max(1.0, abs(float(v))),
                                       err_msg=k)
    want = _leaves({k: params[k] for k in ("world_model", "actor", "critic", "target_critic")})
    got = _leaves(to_flax(*agent))
    for p, value in want.items():
        np.testing.assert_allclose(got[p], value, atol=2e-6, rtol=1e-5, err_msg=p)
    moments_got = _adam_moments(agent, optimizers)
    for name in TRAINED:
        adam_state = exact[name][1][0]
        for slot, tree in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu)):
            w, g = _leaves(tree), _leaves(moments_got[name][slot])
            scale = max(float(np.abs(v).max()) for v in w.values())
            for p in w:
                np.testing.assert_allclose(g[p], w[p], atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{p}")
    np.testing.assert_allclose(moments_state["low"].numpy(), np.asarray(moments["low"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(moments_state["high"].numpy(), np.asarray(moments["high"]), atol=1e-5, rtol=1e-5)
