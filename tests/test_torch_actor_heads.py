"""The port's continuous actor heads against the JAX package's ``Actor``
(``sheeprl_tpu/algos/dreamer_v3/agent.py``), on the CPU at a tiny width:
``normal``, ``tanh_normal`` and ``trunc_normal`` (and DreamerV3's own
``scaled_normal`` beside them), each head's ``act`` on the JAX key's own
draw and greedy, and its ``log_prob_entropy``; ``auto`` resolved per family;
``TruncatedNormal`` against the JAX class; a tiny DreamerV3 run with the
``tanh_normal`` and ``trunc_normal`` heads.

Tolerances: actions and distribution values 1e-5 (fp32 through a two-layer
stack and the same draw); log-probs and entropies 1e-4, as DreamerV3's
(``test_torch_dv3_train.py``), since a tanh-normal's log-prob goes through
an atanh near the bounds."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import Actor as JaxActor
from sheeprl_tpu.ops.distributions import TruncatedNormal as JaxTruncatedNormal
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, build_agent
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.interop.flax_params import _load, actor_spec
from sheeprl_tpu_torch.ops.distributions import TruncatedNormal
from test_torch_dv3_train import OBS_SPACE, TINY
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

LATENT, ACTIONS, ROWS = 12, 3, 64
HEADS = ("normal", "tanh_normal", "trunc_normal", "scaled_normal")
KW = dict(init_std=0.5, min_std=0.1, dense_units=8, mlp_layers=2, action_clip=1.0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _actors(dist: str):
    """The JAX actor, its params perturbed, and the port's on them."""
    jax_actor = JaxActor(latent_state_size=LATENT, actions_dim=(ACTIONS,), is_continuous=True, distribution=dist, **KW)
    params = jax.jit(jax_actor.init)(jax.random.PRNGKey(0), jnp.zeros((1, LATENT)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda a: (np.asarray(a) + 0.3 * rng.normal(size=a.shape)).astype(np.float32),
                                    params)
    # the std half of the head raised: the ``normal`` head passes it raw
    params["params"]["heads_0"]["bias"][ACTIONS:] += 3.0
    actor = Actor(LATENT, (ACTIONS,), True, distribution=dist, **KW)
    _load(actor_spec(actor), params, "", {})
    return jax_actor, params, actor


def _draw(dist: str, key, shape):
    """The draw ``Actor.act`` takes from ``key``."""
    if dist == "trunc_normal":
        return jax.random.uniform(key, shape, minval=1e-6, maxval=1 - 1e-6)
    return jax.random.normal(key, shape)


@pytest.mark.parametrize("dist", HEADS)
def test_act_and_log_prob_entropy_match_the_jax_actor(dist):
    jax_actor, params, actor = _actors(dist)
    assert actor.dist == dist
    latent = np.random.default_rng(2).normal(size=(ROWS, LATENT)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def jax_side(p, x, k):
        sampled = jax_actor.apply(p, x, k, False, method="act")
        greedy = jax_actor.apply(p, x, k, True, method="act")
        return sampled, greedy, jax_actor.apply(p, x, sampled, method="log_prob_entropy")

    sampled, greedy, (lp, ent) = jax_side(params, latent, key)
    noise = _t(np.asarray(jax.jit(lambda k: _draw(dist, k, (ROWS, ACTIONS)))(key)))
    with torch.no_grad():
        got = actor.act(_t(latent), None, False, [noise])
        got_greedy = actor.act(_t(latent), None, True)
        # of the same actions: near the bounds a tanh-normal's atanh turns
        # an ulp of difference in the action into a large one in the log-prob
        got_lp, got_ent = actor.log_prob_entropy(_t(latent), _t(np.asarray(sampled)))
    np.testing.assert_allclose(got.numpy(), np.asarray(sampled), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_greedy.numpy(), np.asarray(greedy), atol=1e-5, rtol=1e-5)
    assert got_lp.shape == got_ent.shape == (ROWS, 1) and np.isfinite(np.asarray(lp)).all()
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(lp), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_ent.numpy(), np.asarray(ent), atol=1e-4, rtol=1e-4)
    assert np.abs(got.numpy()).max() <= 1.0
    if dist == "tanh_normal":
        np.testing.assert_allclose(got_ent.numpy(), -got_lp.numpy(), rtol=0, atol=0)
    # the generator's own draw samples inside the bounds, with a gradient
    latent_t = _t(latent)
    actions = actor.act(latent_t, torch.Generator().manual_seed(0))
    actions.sum().backward()
    assert torch.isfinite(actions).all() and actor.heads[0].weight.grad.abs().sum() > 0


def test_auto_resolves_per_family():
    for default in ("scaled_normal", "tanh_normal", "trunc_normal"):
        jax_actor = JaxActor(latent_state_size=LATENT, actions_dim=(ACTIONS,), is_continuous=True,
                             default_continuous_dist=default, **KW)
        params = jax.jit(jax_actor.init)(jax.random.PRNGKey(0), jnp.zeros((1, LATENT)))
        want = jax_actor.apply(params, method=lambda m: m.dist)
        assert Actor(LATENT, (ACTIONS,), True, default_continuous_dist=default, **KW).dist == want == default
    assert Actor(LATENT, (2, 2), False, default_continuous_dist="tanh_normal", **KW).dist == "discrete"
    with pytest.raises(ValueError, match="Invalid actor distribution"):
        Actor(LATENT, (ACTIONS,), True, distribution="beta", **KW)
    # DreamerV3's agent: auto is scaled_normal, and a configured head is built
    for dist, want in (("auto", "scaled_normal"), ("trunc_normal", "trunc_normal")):
        cfg = compose(TINY + ["env.id=continuous_dummy", f"distribution.type={dist}"])
        assert build_agent((2,), True, cfg, OBS_SPACE).actor.dist == want


def test_truncated_normal_matches_the_jax_class():
    rng = np.random.default_rng(4)
    loc = np.tanh(rng.normal(size=(50, 3))).astype(np.float32)
    loc[0, 0] = 3.0  # far outside the support: Z at its floor
    scale = (0.1 + 2 * rng.random((50, 3))).astype(np.float32)
    value = rng.uniform(-0.99, 0.99, (50, 3)).astype(np.float32)

    @jax.jit
    def jax_side(loc, scale, value):
        d = JaxTruncatedNormal(loc, scale, -1.0, 1.0, event_dims=1)
        key = jax.random.PRNGKey(5)
        draw = jax.random.uniform(key, loc.shape, minval=1e-6, maxval=1 - 1e-6)
        grads = jax.grad(lambda l, s: JaxTruncatedNormal(l, s).rsample(key).sum(), argnums=(0, 1))(loc, scale)
        return d.mean, d.mode, d.log_prob(value), d.entropy(), d.rsample(key), draw, grads

    mean, mode, lp, ent, sample, draw, (g_loc, g_scale) = jax_side(loc, scale, value)
    draw = _t(np.asarray(draw))
    d = TruncatedNormal(_t(loc), _t(scale), -1.0, 1.0, event_dims=1)
    np.testing.assert_allclose(d.mean.numpy(), np.asarray(mean), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(d.mode.numpy(), np.asarray(mode))
    np.testing.assert_allclose(d.log_prob(_t(value)).numpy(), np.asarray(lp), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(d.entropy().numpy(), np.asarray(ent), atol=1e-5, rtol=1e-5)
    # (not at row 0, whose support holds no mass: there the inverse CDF
    # sits on erfinv's pole and either bound is a draw)
    np.testing.assert_allclose(d.rsample(draw).numpy()[1:], np.asarray(sample)[1:], atol=1e-5, rtol=1e-5)
    assert (d.rsample(draw).abs() < 1).all()
    # the reparameterised draw: gradients reach loc and scale as in JAX
    loc_t, scale_t = _t(loc).requires_grad_(True), _t(scale).requires_grad_(True)
    grads = torch.autograd.grad(TruncatedNormal(loc_t, scale_t).rsample(draw).sum(), (loc_t, scale_t))
    np.testing.assert_allclose(grads[0].numpy()[1:], np.asarray(g_loc)[1:], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(grads[1].numpy()[1:], np.asarray(g_scale)[1:], atol=1e-4, rtol=1e-4)


# not ``normal``: it takes the head's std raw, as the JAX package's and
# upstream sheeprl's DreamerV3 actors do, and a negative one is no std
@pytest.mark.parametrize("dist", ["tanh_normal", "trunc_normal"])
def test_a_tiny_dreamer_v3_run_trains_with_each_head(dist, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = cli.run(TINY + ["env.id=continuous_dummy", f"distribution.type={dist}", "fabric.accelerator=cpu",
                          "algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]", "algo.learning_starts=8",
                          "algo.total_steps=16", "buffer.size=32", "env.num_envs=2", "metric.logger=null",
                          "checkpoint.every=100", "checkpoint.save_last=False", "algo.run_test=False"])
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
