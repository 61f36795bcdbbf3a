"""The port's DreamerV3 training slice against the JAX package, on the CPU at
a tiny width: the LayerNorm-GRU cell under autograd, the decoders, heads,
critic and RSSM scans on converted weights, the numerics, distributions and
losses, two consecutive gradient steps from converted params for discrete
and continuous actions, and the ``run`` entry point writing a checkpoint the
JAX package serves.

Random draws go through injected noise taken from the JAX keys with
``make_train_step``'s own splits (``dreamer_v3.py:121``, ``utils.py:88``,
``agent.py:305``, ``dreamer_v3.py:241, 251``, ``agent.py:655``).  Every
argmax the port takes in a compared step is checked to separate the top two
classes of ``logits + noise`` by far more than the tolerance.
"""

from __future__ import annotations

from pathlib import Path

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v3.loss import reconstruction_loss as jax_reconstruction_loss
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.ops import numerics as jn
from sheeprl_tpu.ops.pallas_gru import fused_layernorm_gru as jax_fused_layernorm_gru
from sheeprl_tpu.serving.loader import build_policy as jax_build_policy
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as agent_mod
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, _unimix, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import chunked_dynamic_scan, init_moments_state, update_moments
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_params import _to_flax, param_spec, to_flax
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
from sheeprl_tpu_torch.ops import distributions as td
from sheeprl_tpu_torch.ops import numerics as tn
from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference
from sheeprl_tpu_torch.serving.loader import load_policy
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

GOLDEN = Path(__file__).parent / "golden" / "dv3_goldens.npz"
T, B, H = 4, 2, 3  # sequence length, batch, imagination horizon
STOCH, DISCRETE, REC = 4, 4, 8
TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.capture_video=False",
    "env.screen_size=16",  # two conv stages down to a 4x4 map
    "algo.dense_units=8",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    f"algo.world_model.discrete_size={DISCRETE}",
    f"algo.world_model.stochastic_size={STOCH}",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}",
    f"algo.horizon={H}",
    "diagnostics=off",
    "run_name=tiny",
]
GYM_OBS = gym.spaces.Dict(
    {"rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": gym.spaces.Box(-20, 20, (10,), np.float32)}
)
OBS_SPACE = spaces.Dict(
    {"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)}
)
# fp32 stacks of a few layers: the flax LayerNorm's E[x^2] - E[x]^2 against
# the port's centered variance, and sums in other orders
ATOL = 1e-4
# a compared argmax counts only where logits + noise separate the top two
# classes by far more than the logits' difference across packages (~1e-5)
MARGIN = 2e-4


def _npify(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jit_build(build):
    """``build() -> (params, *rest)`` traced once under ``jax.jit`` (the flax
    init then compiles as one program); ``rest`` leaves through a closure."""
    rest = []

    def traced():
        params, *others = build()
        rest.extend(others)
        return params

    return (_npify(jax.jit(traced)()), *rest)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


class _Setup:
    def __init__(self, env_id: str, actions_dim, is_continuous: bool, extra=()):
        overrides = TINY + [f"env.id={env_id}", *extra]
        self.jax_cfg = jax_compose(overrides)
        self.cfg = compose(overrides)
        self.actions_dim = tuple(actions_dim)
        self.is_continuous = is_continuous

        def build():
            wm_def, actor_def, critic_def, params = jax_build_agent(
                None, self.actions_dim, is_continuous, self.jax_cfg, GYM_OBS
            )
            return params, wm_def, actor_def, critic_def

        params, self.wm_def, self.actor_def, self.critic_def = _jit_build(build)
        # the JAX init leaves LayerNorms, the initial state and the reward and
        # critic heads at 1 / 0; perturb every leaf so each one is exercised
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(
            lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params
        )

    def agent(self):
        return build_agent(self.actions_dim, self.is_continuous, self.cfg, OBS_SPACE, self.params, "cpu")


@pytest.fixture(scope="module")
def disc():
    return _Setup("multidiscrete_dummy", (2, 2), False)


@pytest.fixture(scope="module")
def cont():
    # vector observations only: the image path is the discrete setup's, and
    # the JAX train step compiles in half the time without it
    return _Setup("continuous_dummy", (2,), True, ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]"])


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


# ---------------------------------------------------------------------------
# (1) the LayerNorm-GRU cell under autograd
# ---------------------------------------------------------------------------


def _cell_inputs(seed: int, batch: int = 5, hidden: int = 8, in_dim: int = 6):
    rng = np.random.default_rng(seed)
    k = hidden + in_dim
    return {
        "joint": rng.normal(size=(batch, k)).astype(np.float32),
        "w": (rng.normal(size=(3 * hidden, k)) / np.sqrt(k)).astype(np.float32),
        "b": (0.1 * rng.normal(size=(3 * hidden,))).astype(np.float32),
        "g": (1 + 0.1 * rng.normal(size=(3 * hidden,))).astype(np.float32),
        "beta": (0.1 * rng.normal(size=(3 * hidden,))).astype(np.float32),
        "h": np.tanh(rng.normal(size=(batch, hidden))).astype(np.float32),
        "cot": rng.normal(size=(batch, hidden)).astype(np.float32),
    }


@pytest.mark.parametrize("with_bias", [True, False])
def test_gru_function_grads_match_autograd_of_reference_and_jax_vjp(with_bias):
    x = _cell_inputs(1)
    names = ["joint", "w", "b", "g", "beta", "h"]
    ins = [None if (n == "b" and not with_bias) else _t(x[n]).requires_grad_(True) for n in names]
    out = fused_layernorm_gru(*ins, 1e-3)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, [i for i in ins if i is not None], _t(x["cot"]))
    ref_ins = [None if i is None else i.detach().clone().requires_grad_(True) for i in ins]
    ref_out = ln_gru_reference(*ref_ins, 1e-3)
    ref_grads = torch.autograd.grad(ref_out, [i for i in ref_ins if i is not None], _t(x["cot"]))
    np.testing.assert_allclose(out.detach().numpy(), ref_out.detach().numpy(), atol=1e-6, rtol=0)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6, rtol=0)

    # the JAX kernel (interpret mode) and its custom VJP; w is [K, 3H] there
    # and the bias always present (zeros without one)
    b = x["b"] if with_bias else np.zeros_like(x["b"])
    jax_out, vjp = jax.vjp(
        lambda j, w, b_, g_, be, h: jax_fused_layernorm_gru(j, w, b_, g_, be, h, 1e-3, True),
        x["joint"], x["w"].T, b, x["g"], x["beta"], x["h"],
    )
    jax_grads = vjp(jnp.asarray(x["cot"]))
    # forward: fp32 sums in other orders; gradients of a unit-scale cell
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_out), atol=1e-5, rtol=1e-5)
    want = dict(zip(names, jax_grads))
    want["w"] = np.asarray(want["w"]).T
    got = dict(zip([n for n, i in zip(names, ins) if i is not None], grads))
    for name, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), np.asarray(want[name]), atol=1e-5, rtol=1e-4, err_msg=name)


def test_gru_function_returns_no_grad_for_inputs_that_need_none_and_reaches_a_broadcast_state():
    x = _cell_inputs(2)
    joint = _t(x["joint"]).requires_grad_(True)
    out = fused_layernorm_gru(joint, _t(x["w"]), None, _t(x["g"]), _t(x["beta"]), _t(x["h"]), 1e-3)
    (g_joint,) = torch.autograd.grad(out, [joint], _t(x["cot"]))
    assert g_joint.shape == joint.shape and torch.isfinite(g_joint).all()

    # a learnable initial state broadcast over the batch (a stride-0 view)
    # still receives its gradient through the cell
    cell = LayerNormGRUCell(6, 8, use_bias=False)
    h0 = torch.nn.Parameter(torch.tanh(_t(x["h"][0])))
    inp = _t(x["joint"][:, 8:])
    new_h = cell(h0.expand(5, 8), inp)
    grad = torch.autograd.grad(new_h.sum(), [h0, cell.linear.weight])
    assert grad[0].abs().sum() > 0 and grad[1].abs().sum() > 0


# ---------------------------------------------------------------------------
# (2) modules on converted weights
# ---------------------------------------------------------------------------


def _latent(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, STOCH * DISCRETE + REC)).astype(np.float32)


def test_decoders_heads_and_critic_match(disc):
    agent = disc.agent()
    params = disc.params
    latent = _latent(3, 5)
    wm_apply = jax.jit(lambda m, x: disc.wm_def.apply(params["world_model"], x, method=m), static_argnums=0)
    with torch.no_grad():
        recon = agent.world_model.decode(_t(latent))
        want = wm_apply("decode", latent)
        assert sorted(recon) == sorted(want) == ["rgb", "state"]
        for k in recon:
            np.testing.assert_allclose(recon[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=ATOL, err_msg=k)
        np.testing.assert_allclose(agent.world_model.reward_logits(_t(latent)).numpy(),
                                   np.asarray(wm_apply("reward_logits", latent)), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(agent.world_model.continue_logits(_t(latent)).numpy(),
                                   np.asarray(wm_apply("continue_logits", latent)), atol=ATOL, rtol=ATOL)
        for tree, module in (("critic", agent.critic), ("target_critic", agent.target_critic)):
            want_c = jax.jit(disc.critic_def.apply)(params[tree], latent)
            np.testing.assert_allclose(module(_t(latent)).numpy(), np.asarray(want_c), atol=ATOL, rtol=ATOL)


def _assert_margin(scores: np.ndarray) -> None:
    top2 = np.sort(scores, axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > MARGIN, "near-tie: pick another seed"


def test_rssm_dynamic_scan_and_imagination_with_injected_noise_match(disc):
    agent = disc.agent()
    wm_params = disc.params["world_model"]
    rng = np.random.default_rng(4)
    actions = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B, 2))].reshape(T, B, 4)
    embedded = rng.normal(size=(T, B, agent.world_model.rssm.representation_model.stack.dense[0].in_features - REC))
    embedded = embedded.astype(np.float32)
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[0] = 1.0
    is_first[2, 1] = 1.0
    key = jax.random.PRNGKey(7)

    def jax_scan(actions, embedded, is_first, key):
        def body(carry, x):
            post, rec = carry
            rec, post, _, post_logits, prior_logits = disc.wm_def.apply(wm_params, post, rec, *x, method="dynamic")
            return (post, rec), (rec, post, post_logits, prior_logits)

        keys = jax.random.split(key, T)
        init = (jnp.zeros((B, STOCH * DISCRETE)), jnp.zeros((B, REC)))
        return jax.lax.scan(body, init, (actions, embedded, is_first, keys))[1]

    want = jax.jit(jax_scan)(actions, embedded, is_first, key)
    pairs = [jax.random.split(k) for k in jax.random.split(key, T)]
    prior_noise = np.stack([np.array(jax.random.gumbel(p[0], (B, STOCH, DISCRETE))) for p in pairs])
    post_noise = np.stack([np.array(jax.random.gumbel(p[1], (B, STOCH, DISCRETE))) for p in pairs])
    with torch.no_grad():
        got = chunked_dynamic_scan(agent.world_model, _t(actions), _t(embedded), _t(is_first),
                                   stoch_flat=STOCH * DISCRETE, recurrent_size=REC,
                                   noise=(_t(prior_noise), _t(post_noise)))
    _assert_margin(np.asarray(want[2]).reshape(T, B, STOCH, DISCRETE) + post_noise)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL)

    prior = np.asarray(want[1][-1])
    recurrent = np.asarray(want[0][-1])
    img_key = jax.random.PRNGKey(8)
    jax_prior, jax_rec = jax.jit(
        lambda *a: disc.wm_def.apply(wm_params, *a, method="imagination")
    )(prior, recurrent, actions[0], img_key)
    with torch.no_grad():
        got_prior, got_rec = agent.world_model.imagination(
            _t(prior), _t(recurrent), _t(actions[0]), None,
            _t(np.array(jax.random.gumbel(img_key, (B, STOCH, DISCRETE)))),
        )
    np.testing.assert_allclose(got_rec.numpy(), np.asarray(jax_rec), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got_prior.numpy(), np.asarray(jax_prior), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["disc", "cont"])
def test_actor_log_prob_entropy_matches(kind, request):
    setup = request.getfixturevalue(kind)
    agent = setup.agent()
    latent = _latent(5, 6)
    rng = np.random.default_rng(6)
    if setup.is_continuous:
        actions = np.clip(rng.normal(size=(6, 2)), -1, 1).astype(np.float32)
    else:
        actions = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (6, 2))].reshape(6, 4)
    want = jax.jit(lambda l, a: setup.actor_def.apply(setup.params["actor"], l, a, method="log_prob_entropy"))(
        latent, actions
    )
    with torch.no_grad():
        got = agent.actor.log_prob_entropy(_t(latent), _t(actions))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# (3) numerics, distributions, losses
# ---------------------------------------------------------------------------


def test_two_hot_codec_and_uniform_mix_match_jax():
    x = np.concatenate([np.linspace(-350, 350, 41), [0.0, 2.5, -300.0, 300.0]]).astype(np.float32)[:, None]
    want = np.asarray(jn.two_hot_encoder(jnp.asarray(x), 300))
    got = tn.two_hot_encoder(_t(x), 300).numpy()
    # the two linspaces round the buckets differently (an fp32 ulp at 300 is
    # 3e-5, a weight is a distance over a unit bucket)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tn.two_hot_decoder(_t(want), 300).numpy(),
                               np.asarray(jn.two_hot_decoder(jnp.asarray(want), 300)), atol=1e-4, rtol=1e-6)
    logits = np.random.default_rng(8).normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_allclose(tn.uniform_mix(_t(logits)).numpy(), np.asarray(jn.uniform_mix(jnp.asarray(logits))),
                               atol=1e-6, rtol=1e-6)


def test_distributions_match_goldens_and_jax(golden):
    g = {k: golden[k] for k in golden.files}
    two_hot = td.TwoHotEncodingDistribution(_t(g["twohot_logits"]), dims=1)
    np.testing.assert_allclose(two_hot.log_prob(_t(g["twohot_x"])).numpy(), g["twohot_log_prob"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(two_hot.mean.numpy(), g["twohot_mean"], atol=1e-4, rtol=1e-4)
    symlog = td.SymlogDistribution(_t(g["symlog_mode"]), dims=1)
    np.testing.assert_allclose(symlog.log_prob(_t(g["symlog_target"])).numpy(), g["symlog_log_prob"], atol=1e-4,
                               rtol=1e-4)
    mse = td.MSEDistribution(_t(g["mse_mode"]), dims=3)
    np.testing.assert_allclose(mse.log_prob(_t(g["mse_target"])).numpy(), g["mse_log_prob"], atol=3e-4, rtol=1e-4)
    bern = td.Bernoulli(_t(g["bern_logits"]), event_dims=1)
    np.testing.assert_allclose(bern.log_prob(_t(g["bern_target"])).numpy(), g["bern_log_prob"], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(bern.mode[..., 0].numpy(), g["bern_mode"][..., 0])
    np.testing.assert_allclose(td.kl_categorical(_t(g["ohc_p_logits"]), _t(g["ohc_q_logits"]), event_dims=1).numpy(),
                               g["ohc_kl"], atol=1e-4, rtol=1e-4)
    # values off the bins' grid and at its ends, against the JAX class
    x = np.array([[-1e9], [-3.0], [0.0], [0.123], [7.5], [1e9]], np.float32)
    logits = np.random.default_rng(9).normal(size=(6, 255)).astype(np.float32)
    want = jd.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1).log_prob(jnp.asarray(x))
    np.testing.assert_allclose(td.TwoHotEncodingDistribution(_t(logits), dims=1).log_prob(_t(x)).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-5)


def test_reconstruction_loss_lambda_values_and_moments_match(golden):
    g = {k: golden[k] for k in golden.files}
    po = {"rgb": td.MSEDistribution(_t(g["mse_mode"]), dims=3), "state": td.SymlogDistribution(_t(g["symlog_mode"]), dims=1)}
    observations = {"rgb": _t(g["mse_target"]), "state": _t(g["symlog_target"])}
    out = reconstruction_loss(
        po, observations, td.TwoHotEncodingDistribution(_t(g["twohot_logits"]), dims=1), _t(g["twohot_x"]),
        _t(g["ohc_p_logits"]), _t(g["ohc_q_logits"]), 0.5, 0.1, 1.0, 1.0,
        td.Bernoulli(_t(g["bern_logits"]), event_dims=1), _t(g["bern_target"]), 1.0,
    )
    def jax_loss(g):
        jpo = {"rgb": jd.MSEDistribution(g["mse_mode"], dims=3), "state": jd.SymlogDistribution(g["symlog_mode"], dims=1)}
        return jax_reconstruction_loss(
            jpo, {"rgb": g["mse_target"], "state": g["symlog_target"]},
            jd.TwoHotEncodingDistribution(g["twohot_logits"], dims=1), g["twohot_x"],
            g["ohc_p_logits"], g["ohc_q_logits"], 0.5, 0.1, 1.0, 1.0,
            jd.Bernoulli(g["bern_logits"], event_dims=1), g["bern_target"], 1.0,
        )

    jax_out = jax.jit(jax_loss)({k: g[k] for k in ("mse_mode", "symlog_mode", "mse_target", "symlog_target",
                                                  "twohot_logits", "twohot_x", "ohc_p_logits", "ohc_q_logits",
                                                  "bern_logits", "bern_target")})
    names = ["rec_loss", "kl", "state_loss", "reward_loss", "observation_loss", "continue_loss"]
    for name, ours, theirs in zip(names, out, jax_out):
        np.testing.assert_allclose(ours.numpy(), g[f"recloss_{name}"], atol=3e-4, rtol=3e-4, err_msg=name)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=1e-5, err_msg=name)

    lam = tn.compute_lambda_values(_t(g["lambda_rewards"]), _t(g["lambda_values"]), _t(g["lambda_continues"]), 0.95)
    np.testing.assert_allclose(lam.numpy(), g["lambda_out"], atol=1e-4, rtol=1e-4)

    state = init_moments_state()
    jstate = jax_dv3_utils.init_moments_state()
    for i in (1, 2):
        low, invscale, state = update_moments(state, _t(g[f"moments_seq{i}"]), 0.99, 1.0, 0.05, 0.95)
        jlow, jinv, jstate = jax_dv3_utils.update_moments(jstate, jnp.asarray(g[f"moments_seq{i}"]), 0.99, 1.0,
                                                          0.05, 0.95)
        np.testing.assert_allclose(low.numpy(), g[f"moments_low{i}"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(invscale.numpy(), g[f"moments_invscale{i}"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(low.numpy(), np.asarray(jlow), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(invscale.numpy(), np.asarray(jinv), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# (4) two consecutive gradient steps against make_train_step
# ---------------------------------------------------------------------------


def _batch(setup: _Setup, seed: int):
    rng = np.random.default_rng(seed)
    if setup.is_continuous:
        actions = np.clip(rng.normal(size=(T, B, 2)), -1, 1)
    else:
        actions = np.eye(2)[rng.integers(0, 2, (T, B, 2))].reshape(T, B, 4)
    terminated = np.zeros((T, B, 1))
    terminated[2, 0] = 1.0
    is_first = np.zeros((T, B, 1))
    is_first[3, 0] = 1.0
    return {
        "rgb": rng.integers(0, 256, (T, B, 3, 16, 16)) / 255.0 - 0.5,
        "state": rng.normal(size=(T, B, 10)),
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)),
        "terminated": terminated,
        "is_first": is_first,
    }


def _jax_noise(setup: _Setup, key) -> dict:
    """The draws ``make_train_step`` takes from ``key``, as port noise
    (drawn under one ``jax.jit``: eager draws compile one by one)."""

    def draw(key):
        k_wm, k_img, k_img_actions = jax.random.split(key, 3)
        pairs = [jax.random.split(k) for k in jax.random.split(k_wm, T)]

        def actor_noise(k):
            if setup.is_continuous:
                return [jax.random.normal(k, (T * B, sum(setup.actions_dim)))]
            return [jax.random.gumbel(jax.random.fold_in(k, i), (T * B, d)) for i, d in enumerate(setup.actions_dim)]

        img = [jax.random.split(k) for k in jax.random.split(k_img, H)]
        return {
            "dynamic": (jnp.stack([jax.random.gumbel(p[0], (B, STOCH, DISCRETE)) for p in pairs]),
                        jnp.stack([jax.random.gumbel(p[1], (B, STOCH, DISCRETE)) for p in pairs])),
            "imagination": jnp.stack([jax.random.gumbel(k[0], (T * B, STOCH, DISCRETE)) for k in img]),
            "actor": [actor_noise(k_img_actions)] + [actor_noise(k[1]) for k in img],
        }

    return jax.tree_util.tree_map(_t, jax.jit(draw)(key))


def _record_margins(monkeypatch):
    """Check the margin of every argmax the port's step takes: each
    categorical state and each discrete actor head."""
    original_css = agent_mod.compute_stochastic_state
    original_act = Actor.act

    def css(logits, discrete, generator=None, sample=True, noise=None):
        if sample and noise is not None:
            _assert_margin((logits.detach().reshape(noise.shape) + noise).numpy())
        return original_css(logits, discrete, generator, sample, noise)

    def act(self, state, generator=None, greedy=False, noise=None):
        if not self.is_continuous and noise is not None:
            with torch.no_grad():
                for head, n in zip(self(state), noise):
                    _assert_margin((_unimix(head, head.shape[-1], self.unimix) + n).numpy())
        return original_act(self, state, generator, greedy, noise)

    monkeypatch.setattr(agent_mod, "compute_stochastic_state", css)
    monkeypatch.setattr(Actor, "act", act)


def _adam_moments(agent, optimizers) -> dict:
    """The torch Adam moments in the layout of the flax trees."""
    spec = param_spec(*agent)
    out = {}
    for name in ("world_model", "actor", "critic"):
        state = optimizers[name].state

        def walk(node, slot):
            if isinstance(node, dict):
                return {k: walk(v, slot) for k, v in node.items()}
            tensor, kind = node
            return _to_flax(state[tensor][slot], kind).numpy()

        out[name] = {slot: walk(spec[name], slot) for slot in ("exp_avg", "exp_avg_sq")}
    return out


@pytest.mark.parametrize("kind", ["disc", "cont"])
def test_two_train_steps_match_make_train_step(kind, request, monkeypatch):
    setup = request.getfixturevalue(kind)
    cfg, jax_cfg = setup.cfg, setup.jax_cfg
    opts = {
        k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients), jax_instantiate(jax_cfg.algo[k].optimizer))
        for k in ("world_model", "actor", "critic")
    }
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: opts[k].init(params[k]) for k in opts}
    jax_step = jax_make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, opts, jax_cfg,
                                   setup.actions_dim, setup.is_continuous)
    moments = jax_dv3_utils.init_moments_state()

    agent = setup.agent()
    optimizers = make_optimizers(cfg, agent)
    step = make_train_step(agent, optimizers, cfg, setup.is_continuous)
    state = init_moments_state()
    _record_margins(monkeypatch)

    batch = {k: v.astype(np.float32) for k, v in _batch(setup, 11).items()}
    torch_batch = {k: _t(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    for i, tau in enumerate((1.0, 0.02)):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics = jax_step(
            params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, sub, jnp.float32(tau)
        )[:4]
        state, metrics = step(state, torch_batch, tau, None, _jax_noise(setup, sub))
        # losses in fp32 over a few hundred terms; grad norms of O(100)
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}: {METRIC_ORDER}")

    # updated params of all four trees: two Adam steps of at most lr each
    # (1e-4 / 8e-5) moved them; 2e-6 is 2 % of one step
    want = _leaves({k: params[k] for k in ("world_model", "actor", "critic", "target_critic")})
    got = _leaves(to_flax(*agent))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    # the optimizer moments: optax's (clip, (adam, ...)) chain state
    moments_got = _adam_moments(agent, optimizers)
    for name in ("world_model", "actor", "critic"):
        adam_state = opt_states[name][1][0]
        for slot, tree in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu)):
            w, g = _leaves(tree), _leaves(moments_got[name][slot])
            assert sorted(w) == sorted(g)
            scale = max(float(np.abs(v).max()) for v in w.values())
            for path in w:
                np.testing.assert_allclose(g[path], w[path], atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")
    np.testing.assert_allclose(state["low"].numpy(), np.asarray(moments["low"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state["high"].numpy(), np.asarray(moments["high"]), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the converter and the entry point
# ---------------------------------------------------------------------------


def test_converter_round_trips_conv_transpose_and_all_four_trees(disc):
    back = _leaves(to_flax(*disc.agent()))
    want = _leaves(disc.params)
    assert sorted(back) == sorted(want)
    assert any("ConvTranspose" in p for p in want)
    for path, value in want.items():
        assert back[path].dtype == value.dtype and np.array_equal(back[path], value), path


RUN = TINY + [
    "env.id=discrete_dummy",
    "fabric.accelerator=cpu",
    "algo.learning_starts=8",
    "algo.total_steps=16",
    "buffer.size=32",
    "env.num_envs=2",
    "metric.log_every=8",
    "metric.logger=null",
    "checkpoint.every=100",
]


def test_run_on_the_cpu_writes_a_checkpoint_the_jax_package_serves(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = cli.run(RUN)
    assert out["gradient_steps"] > 0 and out["player_steps"] > 0
    assert out["metric_rows"].shape == (out["train_iterations"], len(METRIC_ORDER))  # one row an iteration
    assert np.isfinite(out["metric_rows"]).all()
    ckpt = out["checkpoints"][-1]
    state = load_state(ckpt)
    assert {"world_model", "actor", "critic", "target_critic", "opt_states", "moments", "rb"} <= set(state)
    with open(Path(out["log_dir"]) / "config.yaml") as fp:
        archived = yaml.safe_load(fp)
    assert archived["algo"]["name"] == "dreamer_v3"

    # the JAX package's serving loader acts on the port's checkpoint as the
    # port's own loader does
    jax_cfg = jax_compose(TINY + ["env.id=discrete_dummy"])
    agent_state = {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")}

    def build():
        handle = jax_build_policy(jax_cfg, GYM_OBS, gym.spaces.Discrete(2), agent_state)
        return handle.params, handle

    jax_params, jax_handle = _jit_build(build)
    handle = load_policy(compose(RUN), ckpt, "cpu")
    rng = np.random.default_rng(12)
    obs = {"rgb": rng.integers(0, 256, (3, 3, 16, 16), dtype=np.uint8),
           "state": rng.normal(size=(3, 10)).astype(np.float32)}
    is_first = np.ones((3, 1), np.float32)
    jstate = {k: np.zeros((3,) + shape, dtype) for k, (shape, dtype) in handle.state_spec.items()}
    key = jax.random.PRNGKey(0)
    want, _ = jax.jit(jax_handle.make_state_step(True))(jax_params, jstate, obs, is_first, key)
    noise = {"representation": _t(np.array(jax.random.gumbel(jax.random.split(key)[0], (3, STOCH, DISCRETE))))}
    got, _ = handle.make_state_step(True)(handle.params, {k: _t(v) for k, v in jstate.items()},
                                          {k: _t(v) for k, v in obs.items()}, _t(is_first), None, noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_run_refuses_options_it_does_not_port(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # diagnostics run (the default); the JAX compilation cache has no eager counterpart
    with pytest.raises(NotImplementedError, match="diagnostics.compilation_cache_dir"):
        cli.run(RUN + ["diagnostics.compilation_cache_dir=cache"])
    # the executors and video capture are ported: the dummy env renders no
    # image, so its run goes on without video and warns, as the JAX one does
    from sheeprl_tpu_torch.envs.env import make_env_fns

    with pytest.warns(UserWarning, match="Video capture disabled"):
        make_env_fns(compose(RUN + ["env.capture_video=True"]), str(tmp_path))[0]().close()
    # offline training is ported: routed to the offline loop, which needs a dataset
    with pytest.raises(ValueError, match="requires algo.offline.dataset_dir"):
        cli.run(RUN + ["algo.offline.enabled=True"])
    # ported: without mlflow check_configs warns and disables the registry, as
    # the JAX one does; the profiler traces the run (tests/test_torch_records.py)
    cfg = compose(RUN + ["model_manager.disabled=False", "metric.profiler.enabled=True"])
    with pytest.warns(UserWarning, match="MLFlow is not installed; setting model_manager.disabled=True"):
        cli.check_configs(cfg)
    assert cfg.model_manager.disabled is True
    # FSDP is ported (tests/test_torch_fsdp*.py): an axis that does not
    # divide the one device is refused with the JAX check_configs' error
    with pytest.raises(ValueError, match=r"fsdp_axis_size \(2\) must divide fabric.devices \(1\)"):
        cli.run(RUN + ["fabric.fsdp=2"])
    # 64-true trains in float32, as the JAX package does without x64
    with pytest.warns(UserWarning, match="requests float64; the run trains in float32"):
        out = cli.run(RUN + ["fabric.precision=64-true", "root_dir=x64"])
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    # the decoupled player/trainer is ported (tests/test_torch_decoupled_*.py):
    # one device is refused by the JAX check_configs' rule
    with pytest.raises(RuntimeError, match="Decoupled algorithm 'ppo_decoupled' needs at least 2 devices"):
        cli.run(RUN + ["exp=ppo_decoupled", "fabric.devices=1"])
