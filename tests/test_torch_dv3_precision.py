"""The precision policy (``fabric.precision``) against the JAX package's, on
the CPU at a tiny width: the dtype table, the per-loss cast and its
gradient, LayerNorm and the LayerNorm-GRU cell in bf16, two ``bf16-mixed``
gradient steps against ``make_train_step``, and ``bf16-true`` storage.

bf16 holds 8 significant bits (a relative step of 2^-8 = 0.4 %).  The two
packages round in different places (flax rounds the GRU's projection to
bf16 before its LayerNorm, the kernel and its plain version keep it fp32;
XLA and PyTorch order their sums differently), so the bf16 comparisons are
held to tolerances of a few bf16 steps, stated at each check.  For scale:
on these inputs the JAX step in fp32 and in bf16 differ by up to 2.6x in a
metric.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.models.blocks import LayerNormGRUCell as JaxLayerNormGRUCell
from sheeprl_tpu.parallel.precision import PRECISION_DTYPES as JAX_PRECISION_DTYPES
from sheeprl_tpu.parallel.precision import cast_floating as jax_cast_floating
from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
from sheeprl_tpu_torch.parallel.precision import (
    PRECISION_DTYPES,
    call_cast,
    cast_floating,
    compute_dtype_of,
    resolve_precision,
    training_dtypes,
)
from sheeprl_tpu_torch.parallel.runtime import Runtime
from sheeprl_tpu_torch.utils.utils import dotdict
from test_torch_dv3_train import DISCRETE, STOCH, H, B, T, _adam_moments, _batch, _leaves, _Setup, _t
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

BF16_STEP = 2.0**-8


def test_precision_table_matches_jax_and_the_runtime_takes_it():
    assert list(PRECISION_DTYPES) == list(JAX_PRECISION_DTYPES)
    for name, (param, compute) in PRECISION_DTYPES.items():
        jparam, jcompute = JAX_PRECISION_DTYPES[name]
        assert (str(param).split(".")[-1], str(compute).split(".")[-1]) == (jnp.dtype(jparam).name,
                                                                            jnp.dtype(jcompute).name)
        assert resolve_precision(name) == (param, compute)
    with pytest.raises(ValueError, match="Unknown precision"):
        resolve_precision("8-true")
    assert compute_dtype_of(dotdict({"fabric": {"precision": "bf16-mixed"}})) == torch.bfloat16
    assert compute_dtype_of(dotdict({})) == torch.float32
    for name in ("32-true", "16-mixed", "bf16-mixed", "bf16-true"):
        rt = Runtime(accelerator="cpu", precision=name)
        assert (rt.param_dtype, rt.compute_dtype) == PRECISION_DTYPES[name] == training_dtypes(name)
    # 64-true: the table's float64, trained in float32 as the JAX package's
    # casts truncate it (jax_enable_x64 is off), with a warning
    assert jnp.zeros(2).astype(jnp.float64).dtype == jnp.float32
    with pytest.warns(UserWarning, match="requests float64; the run trains in float32"):
        rt = Runtime(accelerator="cpu", precision="64-true")
    assert (rt.param_dtype, rt.compute_dtype) == training_dtypes("64-true") == (torch.float32, torch.float32)
    assert compute_dtype_of(dotdict({"fabric": {"precision": "64-true"}})) == torch.float32


def test_the_cast_brings_fp32_gradients_to_fp32_masters_as_jax_does():
    """A dense layer and a LayerNorm run in bf16 through ``call_cast``; the
    gradient of the fp32 master equals ``jax.grad`` through
    ``cast_floating`` of the flax modules, within four bf16 steps of the
    largest (the bias and scale gradients sum six bf16 rows, rounded at
    each add by XLA and once by PyTorch)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    cot = rng.normal(size=(6, 7)).astype(np.float32)
    dense, norm = torch.nn.Linear(5, 7), torch.nn.LayerNorm(7, eps=1e-3)
    with torch.no_grad():
        for p in (*dense.parameters(), *norm.parameters()):
            p.copy_(_t(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    bf16_in = _t(x).to(torch.bfloat16)
    out = call_cast((dense, norm), torch.bfloat16, lambda: norm(dense(bf16_in)))
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float(), [dense.weight, dense.bias, norm.weight, norm.bias], _t(cot))
    assert all(g.dtype == torch.float32 for g in grads)
    assert dense.weight.dtype == torch.float32  # the masters themselves stay fp32

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.LayerNorm(epsilon=1e-3)(fnn.Dense(7)(x))

    params = {"params": {
        "Dense_0": {"kernel": dense.weight.detach().numpy().T, "bias": dense.bias.detach().numpy()},
        "LayerNorm_0": {"scale": norm.weight.detach().numpy(), "bias": norm.bias.detach().numpy()},
    }}

    def loss(p):
        y = Net().apply(jax_cast_floating(p, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
        assert y.dtype == jnp.bfloat16
        return jnp.sum(y.astype(jnp.float32) * cot)

    want = jax.grad(loss)(params)["params"]
    assert want["Dense_0"]["kernel"].dtype == jnp.float32
    for g, w in zip(grads, (want["Dense_0"]["kernel"].T, want["Dense_0"]["bias"], want["LayerNorm_0"]["scale"],
                            want["LayerNorm_0"]["bias"])):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=4 * BF16_STEP * scale, rtol=0)


def test_layernorm_and_the_gru_cell_in_bf16_match_flax():
    """Both LayerNorms take their statistics in fp32 and round their output
    to bf16 once; the GRU cell (the kernel's plain version on the CPU) keeps
    the projection in fp32 where flax rounds it to bf16, so its output may
    differ by a bf16 step of the state or two."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.normal(size=24)).astype(np.float32), (0.1 * rng.normal(size=24)).astype(np.float32)
    ln = torch.nn.LayerNorm(24, eps=1e-3)
    with torch.no_grad():
        ln.weight.copy_(_t(scale))
        ln.bias.copy_(_t(bias))
    got = call_cast((ln,), torch.bfloat16, lambda: ln(_t(x).to(torch.bfloat16)))
    want = fnn.LayerNorm(epsilon=1e-3).apply(
        {"params": {"scale": jnp.asarray(scale, jnp.bfloat16), "bias": jnp.asarray(bias, jnp.bfloat16)}},
        jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2 * BF16_STEP * 4, rtol=0)  # |y| < 4 here: two bf16 steps at that size

    hidden, in_dim = 8, 6
    cell = LayerNormGRUCell(in_dim, hidden, use_bias=False)
    with torch.no_grad():
        cell.linear.weight.copy_(_t((rng.normal(size=(3 * hidden, hidden + in_dim)) / 4).astype(np.float32)))
        cell.norm.weight.copy_(_t((1 + 0.1 * rng.normal(size=3 * hidden)).astype(np.float32)))
        cell.norm.bias.copy_(_t((0.1 * rng.normal(size=3 * hidden)).astype(np.float32)))
    h = np.tanh(rng.normal(size=(5, hidden))).astype(np.float32)
    inp = rng.normal(size=(5, in_dim)).astype(np.float32)
    got = call_cast((cell,), torch.bfloat16, lambda: cell(_t(h).to(torch.bfloat16), _t(inp).to(torch.bfloat16)))
    flax_params = {"params": {"Dense_0": {"kernel": cell.linear.weight.detach().numpy().T},
                              "LayerNorm_0": {"scale": cell.norm.weight.detach().numpy(),
                                              "bias": cell.norm.bias.detach().numpy()}}}
    want = JaxLayerNormGRUCell(hidden, use_bias=False).apply(
        jax_cast_floating(flax_params, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16), jnp.asarray(inp, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=4 * BF16_STEP, rtol=0)  # |h'| < 1


@pytest.fixture(scope="module")
def mixed():
    return _Setup("multidiscrete_dummy", (2, 2), False, ["fabric.precision=bf16-mixed"])


def _jax_noise_bf16(setup, key):
    """The draws of ``make_train_step`` under bf16: ``jax.random.categorical``
    draws its Gumbel noise in the logits' dtype, bf16 here."""
    bf = jnp.bfloat16

    def draw(key):
        k_wm, k_img, k_img_actions = jax.random.split(key, 3)
        pairs = [jax.random.split(k) for k in jax.random.split(k_wm, T)]

        def actor_noise(k):
            return [jax.random.gumbel(jax.random.fold_in(k, i), (T * B, d), bf) for i, d in enumerate(setup.actions_dim)]

        img = [jax.random.split(k) for k in jax.random.split(k_img, H)]
        return {
            "dynamic": (jnp.stack([jax.random.gumbel(p[0], (B, STOCH, DISCRETE), bf) for p in pairs]),
                        jnp.stack([jax.random.gumbel(p[1], (B, STOCH, DISCRETE), bf) for p in pairs])),
            "imagination": jnp.stack([jax.random.gumbel(k[0], (T * B, STOCH, DISCRETE), bf) for k in img]),
            "actor": [actor_noise(k_img_actions)] + [actor_noise(k[1]) for k in img],
        }

    return jax.tree_util.tree_map(lambda a: _t(np.asarray(a).astype(np.float32)), jax.jit(draw)(key))


# the losses: a few bf16 steps of rounding through the stacks; the gradient
# norms: bf16 gradients summed over every parameter (the critic's moves most)
LOSS_RTOL, NORM_RTOL = 3e-2, 0.2
# the Adam first moments of each tree, as a whole: ||port - jax|| / ||jax||.
# On these inputs the port is within 0.04 (world model), 0.02 (actor) and
# 0.24 (critic) of the JAX step in bf16, and the JAX step in fp32 0.32-0.41,
# 1.46-1.53 and 0.35-0.61 away from it: the critic's gradient is a small
# difference of its two log-prob terms, which bf16 rounding moves most
MOMENT_REL = {"world_model": 0.1, "actor": 0.1, "critic": 0.3}


def test_two_bf16_mixed_train_steps_match_make_train_step(mixed):
    """Two gradient steps under ``fabric.precision=bf16-mixed`` from one set
    of converted params and the JAX step's own bf16 noise.  bf16 leaves no
    room for the argmax margins the fp32 test holds (neighbouring classes
    are often a bf16 step apart, or tied); the losses are what a flipped
    sample would move, and they agree to ``LOSS_RTOL``."""
    cfg, jax_cfg = mixed.cfg, mixed.jax_cfg
    opts = {k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients),
                           jax_instantiate(jax_cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    params = jax.tree_util.tree_map(jnp.asarray, mixed.params)
    opt_states = {k: opts[k].init(params[k]) for k in opts}
    jax_step = jax_make_train_step(mixed.wm_def, mixed.actor_def, mixed.critic_def, opts, jax_cfg, mixed.actions_dim,
                                   False)
    moments = jax_dv3_utils.init_moments_state()
    agent = mixed.agent()
    optimizers = make_optimizers(cfg, agent)
    step = make_train_step(agent, optimizers, cfg, False)
    state = init_moments_state()
    batch = {k: v.astype(np.float32) for k, v in _batch(mixed, 11).items()}
    key = jax.random.PRNGKey(5)
    for i, tau in enumerate((1.0, 0.02)):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics = jax_step(
            params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, sub, jnp.float32(tau))[:4]
        state, metrics = step(state, {k: _t(v) for k, v in batch.items()}, tau, None, _jax_noise_bf16(mixed, sub))
        got, want = metrics.numpy(), np.asarray(jax_metrics)
        assert metrics.dtype == torch.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got[:8], want[:8], rtol=LOSS_RTOL, atol=1e-3, err_msg=f"step {i}: {METRIC_ORDER[:8]}")
        np.testing.assert_allclose(got[8:], want[8:], rtol=NORM_RTOL, err_msg=f"step {i}: {METRIC_ORDER[8:]}")

    # fp32 masters and fp32 Adam state, as the JAX package keeps them
    assert all(p.dtype == torch.float32 for m in agent for p in m.parameters())
    moments_got = _adam_moments(agent, optimizers)
    for name in ("world_model", "actor", "critic"):
        want_tree, got_tree = _leaves(opt_states[name][1][0].mu), _leaves(moments_got[name]["exp_avg"])
        assert sorted(want_tree) == sorted(got_tree)
        diff = np.sqrt(sum(float(((got_tree[p] - want_tree[p]) ** 2).sum()) for p in want_tree))
        norm = np.sqrt(sum(float((want_tree[p] ** 2).sum()) for p in want_tree))
        assert diff / norm < MOMENT_REL[name], f"{name}: Adam first moments differ by {diff / norm:.3g} of their norm"
    np.testing.assert_allclose(state["low"].numpy(), np.asarray(moments["low"]), rtol=LOSS_RTOL, atol=1e-3)
    np.testing.assert_allclose(state["high"].numpy(), np.asarray(moments["high"]), rtol=LOSS_RTOL, atol=1e-3)


def test_bf16_true_stores_bf16_weights_and_adam_state_and_plays_in_fp32():
    setup = _Setup("multidiscrete_dummy", (2, 2), False, ["fabric.precision=bf16-true"])
    agent = setup.agent()
    for module in agent:
        module.to(torch.bfloat16)  # as the training loop stores them under bf16-true
    optimizers = make_optimizers(setup.cfg, agent)
    step = make_train_step(agent, optimizers, setup.cfg, False)
    batch = {k: _t(v.astype(np.float32)) for k, v in _batch(setup, 12).items()}
    _, metrics = step(init_moments_state(), batch, 1.0, torch.Generator().manual_seed(0))
    assert np.isfinite(metrics.numpy()).all()
    assert all(p.dtype == torch.bfloat16 for m in agent for p in m.parameters())
    for opt in optimizers.values():
        for entry in opt.state.values():
            assert entry["exp_avg"].dtype == entry["exp_avg_sq"].dtype == torch.bfloat16
    # the player acts in fp32 on fp32 casts of the bf16 weights, as flax
    # promotes bf16 weights and fp32 observations
    player = PlayerDV3(agent.world_model, agent.actor, (2, 2), 3)
    player.init_states()
    obs = {"rgb": torch.rand(3, 3, 16, 16) - 0.5, "state": torch.randn(3, 10)}
    actions = player.get_actions(obs, torch.Generator().manual_seed(1))
    assert actions.dtype == torch.float32 and all(v.dtype == torch.float32 for v in player.state.values())
    assert all(p.dtype == torch.bfloat16 for p in agent.world_model.parameters())
    assert cast_floating({"a": torch.ones(2), "b": [torch.ones(1, dtype=torch.int64)]}, torch.bfloat16)["a"].dtype \
        == torch.bfloat16
