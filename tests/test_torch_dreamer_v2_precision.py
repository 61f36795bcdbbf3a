"""The port's DreamerV2 under ``fabric.precision=bf16-mixed`` against the
JAX package's, on the CPU at a tiny width: the JAX step's fault under
``bf16-mixed`` (ROADMAP.md Queue 3), and two ``bf16-mixed`` gradient steps
from converted params at the tolerances ``test_torch_dv3_precision.py``
holds DreamerV3's to, against the JAX step with its constant initial state
cast to the compute dtype."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_step as jax_make_train_step
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers
from test_torch_dreamer_v2 import _opt_leaves, _port_opt_leaves, _Setup
from test_torch_dv3_precision import BF16_STEP
from test_torch_dv3_train import _t
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


@pytest.fixture(scope="module")
def setup():
    return _Setup("discrete_dummy", (2,), False, ["fabric.precision=bf16-mixed"])


def _jax_bf16_step(setup):
    return jax_make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, setup.opts, setup.jax_cfg,
                               setup.actions_dim, setup.is_continuous)


def test_the_jax_dreamer_v2_step_fails_under_bf16_mixed(setup):
    """A fault of the reference (ROADMAP.md Queue 3): DreamerV2's initial
    recurrent state is a float32 constant, not a parameter the loss casts,
    so under ``bf16-mixed`` a reset promotes the dynamic scan's carry to
    float32 and ``lax.scan`` refuses the step."""
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: setup.opts[k].init(params[k]) for k in setup.opts}
    with pytest.raises(TypeError, match="carry input and carry output must have equal types"):
        _jax_bf16_step(setup)(params, opt_states, {k: jnp.asarray(v) for k, v in setup.batch(12).items()},
                              jax.random.PRNGKey(6), jnp.float32(1.0))


def _initial_states_in_the_compute_dtype(self, batch_shape):
    """The JAX RSSM's ``get_initial_states`` with its constant state cast
    to the (cast) parameters' dtype, as the port's buffer is cast."""
    from sheeprl_tpu.algos.dreamer_v3.agent import _unimix, compute_stochastic_state

    dtype = jax.tree_util.tree_leaves(self.variables["params"])[0].dtype
    h0 = jnp.tanh(self.initial_recurrent_state) if self.tanh_initial_state else self.initial_recurrent_state
    h0 = jnp.broadcast_to(h0.astype(dtype), tuple(batch_shape) + h0.shape)
    logits = _unimix(self.transition_model(h0), self.discrete_size, self.unimix)
    return h0, compute_stochastic_state(logits, self.discrete_size, None, sample=False)


def test_two_bf16_mixed_train_steps_match_make_train_step(setup, monkeypatch):
    """``bf16-mixed`` at the DreamerV3 precision test's tolerances: the
    losses to 3 %, the gradient norms to 20 %, the Adam first moments of
    each tree as a whole; fp32 masters.  The JAX step runs with its initial
    state cast to the compute dtype, without which it cannot run (above)."""
    from sheeprl_tpu.algos.dreamer_v3.agent import RSSM as JaxRSSM

    monkeypatch.setattr(JaxRSSM, "get_initial_states", _initial_states_in_the_compute_dtype)
    jax_step = _jax_bf16_step(setup)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: setup.opts[k].init(params[k]) for k in setup.opts}
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, False)
    batch = setup.batch(12)
    key = jax.random.PRNGKey(6)
    for i, tau in enumerate((1.0, 0.0)):
        key, sub = jax.random.split(key)
        params, opt_states, jax_metrics = jax_step(params, opt_states, {k: jnp.asarray(v) for k, v in batch.items()},
                                                   sub, jnp.float32(tau))
        _, metrics = step({}, {k: _t(v) for k, v in batch.items()}, tau, None, setup.noise(sub, jnp.bfloat16))
        got, want = metrics.numpy(), np.asarray(jax_metrics)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:8], want[:8], rtol=3e-2, atol=1e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(got[8:], want[8:], rtol=0.2, err_msg=f"step {i}")
    assert all(p.dtype == torch.float32 for m in agent for p in m.parameters())
    want, got = _opt_leaves(opt_states), _port_opt_leaves(agent, optimizers)
    for name, rel in (("world_model", 0.1), ("actor", 0.1), ("critic", 0.3)):
        w, g = want[name], got[name]
        mu = [p for p in w if p.startswith("['mu']")]
        diff = np.sqrt(sum(float(((g[p] - w[p]) ** 2).sum()) for p in mu))
        norm = np.sqrt(sum(float((w[p] ** 2).sum()) for p in mu))
        assert diff / norm < rel, f"{name}: {diff / norm:.3g} (bf16 step {BF16_STEP})"
