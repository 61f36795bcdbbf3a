"""The port's DreamerV3 serving slice against the JAX package, on the CPU at
a tiny width: per-module parity on converted weights, the flax <-> torch
converter, the serving step over rounds with a masked reset, a checkpoint the
JAX package wrote served by the port, and ``/act`` + ``/healthz`` over HTTP.

Sampling parity goes through injected noise:
``jax.random.categorical(k, l) == argmax(l + jax.random.gumbel(k, l.shape))``,
so the Gumbel (and, for the continuous head, normal) draws are taken from the
JAX keys with the JAX code's own splits and handed to the port.  Before one-hot
samples are compared, the top-2 margin of ``logits + noise`` is checked to be
far above the tolerance, so no near-tie decides a comparison.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sheeprl_tpu.algos.dreamer_v3.agent import Actor as FlaxActor
from sheeprl_tpu.algos.dreamer_v3.agent import PlayerDV3 as FlaxPlayerDV3
from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.serving.loader import build_policy as jax_build_policy
from sheeprl_tpu.utils.checkpoint import save_state as jax_save_state
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, PlayerDV3, _unimix, build_agent, build_policy_modules
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_params import (
    NOT_ACTED_WITH,
    _dump,
    from_flax,
    from_flax_policy,
    policy_spec,
    to_flax,
)
from sheeprl_tpu_torch.serving.batcher import pick_bucket
from sheeprl_tpu_torch.serving.loader import (
    PolicyHandle,
    _dict_assembler,
    _row_validator,
    build_policy,
    load_policy,
)
from sheeprl_tpu_torch.serving.server import PolicyService, ServeApp
from sheeprl_tpu_torch.serving.sessions import SessionStore, make_slab_step
from sheeprl_tpu_torch.utils.checkpoint import ForeignObject, load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=multidiscrete_dummy",
    "env.capture_video=False",
    "env.screen_size=16",  # two conv stages down to a 4x4 map; 64x64 takes the JAX init ~20 s on the CPU
    "algo.dense_units=8",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "run_name=tiny",
]
ACTIONS_DIM = (2, 2)  # the multidiscrete dummy env's
STOCH, DISCRETE = 4, 4
# multi-layer fp32 stacks: the flax LayerNorm's E[x^2] - E[x]^2 against the
# port's centered variance, and conv/matmul sums in other orders
ATOL = 1e-4
# a one-hot comparison counts only where logits + noise separate the top two
# classes by far more than ATOL
MARGIN = 1e-2


def _obs_np(batch: int, seed: int):
    rng = np.random.default_rng(seed)
    return {
        "rgb": rng.integers(0, 256, size=(batch, 3, 16, 16), dtype=np.uint8),
        "state": rng.normal(size=(batch, 10)).astype(np.float32),
    }


def _prepared(obs):
    """Image keys scaled like the serving step: uint8 -> [-0.5, 0.5]."""
    return {"rgb": obs["rgb"].astype(np.float32) / 255.0 - 0.5, "state": obs["state"]}


def _torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


def _npify(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_margin(scores: np.ndarray) -> None:
    top2 = np.sort(scores, axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > MARGIN, "near-tie: pick another seed"


def _jit_build(build):
    """Run ``build() -> (params, *rest)`` once under ``jax.jit``: the flax
    init then compiles as one XLA program instead of one per op (about 15 s
    on the CPU).  ``rest`` (module definitions, handles) leaves through a
    closure; the params come back as numpy."""
    rest = []

    def traced():
        params, *others = build()
        rest.extend(others)
        return params

    return (_npify(jax.jit(traced)()), *rest)


@pytest.fixture(scope="module")
def tiny():
    jax_cfg = jax_compose(TINY)
    cfg = compose(TINY)
    gym_obs = gym.spaces.Dict(
        {
            "rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8),
            "state": gym.spaces.Box(-20, 20, (10,), np.float32),
        }
    )
    obs_space = spaces.Dict(
        {"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)}
    )

    def build_agent_defs():
        wm_def, actor_def, _, params = jax_build_agent(None, ACTIONS_DIM, False, jax_cfg, gym_obs)
        return params, wm_def, actor_def

    params, wm_def, actor_def = _jit_build(build_agent_defs)
    # the JAX init leaves the initial state and LayerNorms at 0 / 1; perturb
    # every leaf so the parity checks see the converter move each one
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), params)

    def build_handle():
        handle = jax_build_policy(jax_cfg, gym_obs, gym.spaces.MultiDiscrete(list(ACTIONS_DIM)), params)
        return handle.params, handle

    _, jax_handle = _jit_build(build_handle)
    agent = build_agent(ACTIONS_DIM, False, cfg, obs_space, params, "cpu")
    world_model, actor = agent.world_model, agent.actor
    wm_params = params["world_model"]
    return {
        "jax_cfg": jax_cfg,
        "cfg": cfg,
        "obs_space": obs_space,
        "params": params,
        "jax_handle": jax_handle,
        "wm_def": wm_def,
        "actor_def": actor_def,
        "jax_steps": {g: jax.jit(jax_handle.make_state_step(g)) for g in (True, False)},
        "encode": jax.jit(lambda o: wm_def.apply(wm_params, o, method="encode")),
        "initial_states": jax.jit(lambda: wm_def.apply(wm_params, (3,), method="initial_states")),
        "recurrent_step": jax.jit(lambda *a: wm_def.apply(wm_params, *a, method="recurrent_step")),
        "representation": jax.jit(lambda *a: wm_def.apply(wm_params, *a, method="representation")),
        "act": {
            g: jax.jit(lambda l, k, g=g: actor_def.apply(params["actor"], l, k, g, None, method="act"))
            for g in (True, False)
        },
        "heads": jax.jit(lambda l: actor_def.apply(params["actor"], l)),
        "wm": world_model,
        "actor": actor,
        "agent": agent,
    }


# ---------------------------------------------------------------------------
# per-module parity on converted weights
# ---------------------------------------------------------------------------


def test_encoders_match(tiny):
    obs = _prepared(_obs_np(3, seed=1))
    want = np.asarray(tiny["encode"](obs))
    with torch.no_grad():
        cnn = tiny["wm"].cnn_encoder(_torch(obs)).numpy()
        mlp = tiny["wm"].mlp_encoder(_torch(obs)).numpy()
        got = tiny["wm"].encode(_torch(obs)).numpy()
    # the embedding is [cnn (h, w, c) flatten | mlp]
    np.testing.assert_allclose(cnn, want[:, : cnn.shape[1]], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(mlp, want[:, cnn.shape[1] :], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_initial_states_match(tiny):
    h0, z0 = tiny["initial_states"]()
    with torch.no_grad():
        g_h0, g_z0 = tiny["wm"].initial_states((3,))
    np.testing.assert_allclose(g_h0.numpy(), np.asarray(h0), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(g_z0.numpy(), np.asarray(z0), atol=0, rtol=0)


def test_recurrent_step_matches(tiny):
    rng = np.random.default_rng(2)
    stoch = rng.normal(size=(5, STOCH * DISCRETE)).astype(np.float32)
    actions = rng.normal(size=(5, sum(ACTIONS_DIM))).astype(np.float32)
    recurrent = np.tanh(rng.normal(size=(5, 8))).astype(np.float32)
    want = tiny["recurrent_step"](stoch, actions, recurrent)
    with torch.no_grad():
        got = tiny["wm"].recurrent_step(*(torch.from_numpy(a) for a in (stoch, actions, recurrent)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_representation_with_injected_gumbel_matches(tiny):
    rng = np.random.default_rng(3)
    recurrent = np.tanh(rng.normal(size=(6, 8))).astype(np.float32)
    embedded = np.array(tiny["encode"](_prepared(_obs_np(6, 4))))
    key = jax.random.PRNGKey(11)
    logits, stoch = tiny["representation"](recurrent, embedded, key)
    noise = np.array(jax.random.gumbel(key, (6, STOCH, DISCRETE), jnp.float32))
    with torch.no_grad():
        g_logits, g_stoch = tiny["wm"].representation(
            torch.from_numpy(recurrent), torch.from_numpy(embedded), None, torch.from_numpy(noise)
        )
    np.testing.assert_allclose(g_logits.numpy(), np.asarray(logits), atol=ATOL, rtol=ATOL)
    _assert_margin(np.asarray(logits).reshape(6, STOCH, DISCRETE) + noise)
    np.testing.assert_allclose(g_stoch.numpy(), np.asarray(stoch), atol=1e-6, rtol=0)


@pytest.mark.parametrize("greedy", [True, False])
def test_discrete_actor_act_matches(tiny, greedy):
    rng = np.random.default_rng(5)
    latent = rng.normal(size=(7, STOCH * DISCRETE + 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(tiny["act"][greedy](latent, key))
    heads = tiny["heads"](latent)
    noise = None
    if not greedy:
        # Actor.act draws head i from fold_in(key, i)
        noise = [np.array(jax.random.gumbel(jax.random.fold_in(key, i), h.shape, jnp.float32)) for i, h in enumerate(heads)]
    for i, h in enumerate(heads):
        mixed = np.log(0.99 * np.asarray(jax.nn.softmax(h, axis=-1)) + 0.01 / h.shape[-1])
        _assert_margin(mixed + (0 if noise is None else noise[i]))
    with torch.no_grad():
        got = tiny["actor"].act(
            torch.from_numpy(latent), None, greedy, None if noise is None else [torch.from_numpy(n) for n in noise]
        )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("greedy", [True, False])
def test_continuous_scaled_normal_actor_act_matches(tiny, greedy):
    latent_size = STOCH * DISCRETE + 8
    flax_actor = FlaxActor(latent_state_size=latent_size, actions_dim=(3,), is_continuous=True, dense_units=8,
                           mlp_layers=2)
    latent = np.random.default_rng(6).normal(size=(4, latent_size)).astype(np.float32)
    actor_params = _npify(jax.jit(flax_actor.init)(jax.random.PRNGKey(1), latent))
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda l, k: flax_actor.apply(actor_params, l, k, greedy, None, method="act"))(latent, key))
    actor = Actor(latent_size, (3,), True, dense_units=8, mlp_layers=2)
    agent = tiny["agent"]
    from_flax({**tiny["params"], "actor": actor_params}, tiny["wm"], actor, agent.critic, agent.target_critic)
    noise = None if greedy else [torch.from_numpy(np.array(jax.random.normal(key, (4, 3))))]
    with torch.no_grad():
        got = actor.act(torch.from_numpy(latent), None, greedy, noise)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------


def test_converter_round_trip_is_bit_exact(tiny):
    back = to_flax(*tiny["agent"])
    want = tiny["params"]  # all four trees: the converter skips nothing
    want_leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(want)}
    got_leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, value in want_leaves.items():
        got = got_leaves[path]
        assert got.dtype == value.dtype and got.shape == value.shape and np.array_equal(got, value), path


@pytest.mark.parametrize("fault", ["unknown_key", "missing_key", "wrong_shape", "missing_tree"])
def test_converter_is_strict(tiny, fault):
    tree = jax.tree_util.tree_map(np.copy, tiny["params"])
    rssm = tree["world_model"]["params"]["rssm"]
    if fault == "unknown_key":
        rssm["bogus"] = np.zeros(3, np.float32)
        error = KeyError
    elif fault == "missing_key":
        del rssm["initial_recurrent_state"]
        error = KeyError
    elif fault == "wrong_shape":
        rssm["initial_recurrent_state"] = np.zeros(9, np.float32)
        error = ValueError
    else:  # training reads all four trees (serving reads two: see below)
        del tree["target_critic"]
        error = KeyError
    agent = build_agent(ACTIONS_DIM, False, tiny["cfg"], tiny["obs_space"], None, "cpu")
    with pytest.raises(error):
        from_flax(tree, *agent)


def _policy_trees(params):
    """A checkpoint's trees cut down to the world model's encoders and RSSM
    and the actor: no critics, decoders or reward and continue heads."""
    wm = {k: v for k, v in params["world_model"]["params"].items() if k not in NOT_ACTED_WITH["/world_model/params"]}
    return {"world_model": {"params": wm}, "actor": params["actor"]}


def _leaf_dict(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", ["two_trees", "four_trees", "seeded", "missing_actor", "unknown_key"])
def test_policy_converter_reads_only_what_the_policy_acts_with(tiny, case):
    cfg, obs_space = tiny["cfg"], tiny["obs_space"]
    trees = jax.tree_util.tree_map(np.copy, tiny["params"] if case == "four_trees" else _policy_trees(tiny["params"]))
    world_model, actor = build_policy_modules(ACTIONS_DIM, False, cfg, obs_space, None, "cpu")
    assert world_model.cnn_decoder is None and world_model.reward_model is None
    if case == "seeded":  # the seed's weights are build_agent's
        want = _policy_trees(to_flax(*build_agent(ACTIONS_DIM, False, cfg, obs_space, None, "cpu")))
    elif case in ("two_trees", "four_trees"):
        from_flax_policy(trees, world_model, actor)
        want = _policy_trees(tiny["params"])
    else:
        if case == "missing_actor":
            del trees["actor"]
        else:
            trees["world_model"]["params"]["rssm"]["bogus"] = np.zeros(3, np.float32)
        with pytest.raises(KeyError):
            from_flax_policy(trees, world_model, actor)
        return
    got, want = _leaf_dict(_dump(policy_spec(world_model, actor))), _leaf_dict(want)
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        assert np.array_equal(got[path], value), path


# ---------------------------------------------------------------------------
# the serving step
# ---------------------------------------------------------------------------


def _port_noise(key, batch: int, greedy: bool):
    """The draws the JAX serving step takes from ``key``:
    ``k1, k2 = split(key)``; the posterior from k1, head i from
    ``fold_in(k2, i)``."""
    k1, k2 = jax.random.split(key)
    noise = {"representation": torch.from_numpy(np.array(jax.random.gumbel(k1, (batch, STOCH, DISCRETE), jnp.float32)))}
    if not greedy:
        noise["actor"] = [
            torch.from_numpy(np.array(jax.random.gumbel(jax.random.fold_in(k2, i), (batch, d), jnp.float32)))
            for i, d in enumerate(ACTIONS_DIM)
        ]
    return noise


def _margins_hold(handle, run, noise):
    """Run ``run()`` with the port's representation and actor heads hooked,
    and assert that ``logits + noise`` separates the top two classes of
    every draw by more than ``MARGIN``."""
    wm, actor = handle.params["world_model"], handle.params["actor"]
    seen = {}
    hooks = [wm.rssm.representation_model.register_forward_hook(lambda m, i, o: seen.__setitem__("repr", o))]
    for j, head in enumerate(actor.heads):
        hooks.append(head.register_forward_hook(lambda m, i, o, j=j: seen.__setitem__(j, o)))
    try:
        out = run()
    finally:
        for hook in hooks:
            hook.remove()
    repr_logits = _unimix(seen["repr"], DISCRETE, 0.01).reshape(-1, STOCH, DISCRETE)
    _assert_margin((repr_logits + noise["representation"]).numpy())
    for j, d in enumerate(ACTIONS_DIM):
        logits = _unimix(seen[j], d, 0.01)
        _assert_margin((logits + (noise["actor"][j] if "actor" in noise else 0)).numpy())
    return out


@pytest.mark.parametrize("greedy", [True, False])
def test_state_step_matches_jax_handle_over_rounds_with_masked_reset(tiny, greedy):
    jax_handle = tiny["jax_handle"]
    handle = build_policy(tiny["cfg"], tiny["obs_space"], spaces.MultiDiscrete(list(ACTIONS_DIM)), tiny["params"], "cpu")
    assert handle.state_spec == jax_handle.state_spec
    jax_step = tiny["jax_steps"][greedy]
    step = handle.make_state_step(greedy)
    batch = 2
    jstate = {k: np.zeros((batch,) + shape, dtype) for k, (shape, dtype) in handle.state_spec.items()}
    state = _torch(jstate)
    for round_no, is_first in enumerate(([[1.0], [1.0]], [[0.0], [0.0]], [[1.0], [0.0]])):
        obs = _obs_np(batch, seed=20 + round_no)
        is_first = np.asarray(is_first, np.float32)
        key = jax.random.PRNGKey(0) if greedy else jax.random.PRNGKey(100 + round_no)
        want_actions, jstate = jax_step(tiny["params"], jstate, obs, is_first, key)
        noise = _port_noise(key, batch, greedy)
        got_actions, state = _margins_hold(
            handle, lambda: step(handle.params, state, _torch(obs), torch.from_numpy(is_first), None, noise), noise
        )
        np.testing.assert_allclose(got_actions.numpy(), np.asarray(want_actions), atol=1e-6, rtol=0)
        np.testing.assert_allclose(state["recurrent"].numpy(), np.asarray(jstate["recurrent"]), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(state["stochastic"].numpy(), np.asarray(jstate["stochastic"]), atol=1e-6, rtol=0)


def test_player_matches_jax_player_with_a_masked_reset(tiny):
    """``PlayerDV3``: a full init, one step, a masked reset of env 0, a
    second step; greedy, the posterior drawn from the JAX player's key."""
    params = tiny["params"]
    jax_player = FlaxPlayerDV3(tiny["wm_def"], tiny["actor_def"], ACTIONS_DIM, num_envs=2)
    player = PlayerDV3(tiny["wm"], tiny["actor"], ACTIONS_DIM, num_envs=2)
    jax_player.init_states(params["world_model"])
    player.init_states()
    for step_no in range(2):
        if step_no == 1:
            mask = np.asarray([[1.0], [0.0]], np.float32)
            jax_player.init_states(params["world_model"], reset_mask=mask)
            player.init_states(torch.from_numpy(mask))
        obs = _prepared(_obs_np(2, seed=60 + step_no))
        key = jax.random.PRNGKey(step_no)
        want = jax_player.get_actions(params["world_model"], params["actor"], obs, key, greedy=True)
        got = player.get_actions(_torch(obs), None, True, _port_noise(key, 2, True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        np.testing.assert_allclose(player.state["recurrent"].numpy(), np.asarray(jax_player.state["recurrent"]),
                                   atol=ATOL, rtol=ATOL)


def test_jax_written_checkpoint_is_served_with_the_same_greedy_actions(tiny, tmp_path):
    import optax

    run_dir = tmp_path / "run"
    run_dir.mkdir()
    with open(run_dir / "config.yaml", "w") as fp:
        yaml.safe_dump(tiny["jax_cfg"].as_dict(), fp)
    ckpt = run_dir / "checkpoint" / "ckpt_64_0.ckpt"
    params = tiny["params"]
    jax_save_state(
        str(ckpt),
        {**params, "opt_states": {"actor": optax.adam(1e-3).init(params["actor"])}, "iter_num": 3},
    )
    adam_state = load_state(str(ckpt))["opt_states"]["actor"]
    assert any(isinstance(x, ForeignObject) for x in adam_state)  # optax classes, loaded without optax

    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert device == torch.device("cpu") and cfg.serving.batch_buckets == [8, 16, 32, 64, 128]
    handle = load_policy(cfg, ckpt_path, device)
    jax_handle = tiny["jax_handle"]
    assert handle.ckpt_step == 64
    assert handle.obs_spec == jax_handle.obs_spec and handle.action_shape == jax_handle.action_shape
    batch = 3
    obs = _obs_np(batch, seed=40)
    is_first = np.ones((batch, 1), np.float32)
    jstate = {k: np.zeros((batch,) + shape, dtype) for k, (shape, dtype) in handle.state_spec.items()}
    key = jax.random.PRNGKey(0)
    want, _ = tiny["jax_steps"][True](params, jstate, obs, is_first, key)
    noise = _port_noise(key, batch, True)
    got, _ = _margins_hold(
        handle,
        lambda: handle.make_state_step(True)(handle.params, _torch(jstate), _torch(obs), torch.from_numpy(is_first),
                                             None, noise),
        noise,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_two_tree_checkpoint_is_served_with_the_same_greedy_actions(tiny, tmp_path):
    """A checkpoint holding only what the policy acts with (no critics,
    decoders or reward and continue heads) serves, as the JAX package's
    ``build_policy`` serves it."""
    from sheeprl_tpu_torch.utils.checkpoint import save_state

    run_dir = tmp_path / "run"
    (run_dir / "checkpoint").mkdir(parents=True)
    with open(run_dir / "config.yaml", "w") as fp:
        yaml.safe_dump(tiny["cfg"].as_dict(), fp)
    ckpt = run_dir / "checkpoint" / "ckpt_16_0.ckpt"
    save_state(str(ckpt), _policy_trees(tiny["params"]))
    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    handle = load_policy(cfg, ckpt_path, device)
    assert handle.ckpt_step == 16
    batch = 3
    obs = _obs_np(batch, seed=41)
    is_first = np.ones((batch, 1), np.float32)
    jstate = {k: np.zeros((batch,) + shape, dtype) for k, (shape, dtype) in handle.state_spec.items()}
    key = jax.random.PRNGKey(1)
    want, _ = tiny["jax_steps"][True](tiny["params"], jstate, obs, is_first, key)
    noise = _port_noise(key, batch, True)
    got, _ = _margins_hold(
        handle,
        lambda: handle.make_state_step(True)(handle.params, _torch(jstate), _torch(obs), torch.from_numpy(is_first),
                                             None, noise),
        noise,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# sessions and batching, with a counter policy: the action is the number of
# steps the session has taken since its last reset
# ---------------------------------------------------------------------------


def _counter_handle() -> PolicyHandle:
    obs_spec = {"x": ((1,), "float32")}

    def make_state_step(greedy):
        def step(params, state, obs, is_first, generator, noise=None):
            count = (1.0 - is_first) * state["count"] + 1.0
            return count, {"count": count}

        return step

    return PolicyHandle(
        algo="counter",
        obs_spec=obs_spec,
        action_shape=(1,),
        params={},
        assemble=_dict_assembler(obs_spec),
        validate=_row_validator(obs_spec),
        device=torch.device("cpu"),
        stateful=True,
        state_spec={"count": ((1,), "float32")},
        make_state_step=make_state_step,
    )


OBS = {"x": [0.0]}


def _service(capacity: int = 4, max_delay_ms: float = 1.0, buckets=(2, 4)) -> PolicyService:
    return PolicyService(
        _counter_handle(),
        {"batch_buckets": list(buckets), "max_delay_ms": max_delay_ms, "sessions": {"capacity": capacity}},
    ).start()


def _count(result) -> float:
    return float(np.asarray(result["action"]).reshape(-1)[0])


def test_pick_bucket():
    assert pick_bucket(1, (8, 16)) == 8
    assert pick_bucket(9, (16, 8)) == 16
    with pytest.raises(ValueError):
        pick_bucket(17, (8, 16))


def test_session_accumulates_resets_and_isolates_sessionless():
    svc = _service()
    try:
        assert [_count(svc.act(OBS, session="s")) for _ in range(3)] == [1.0, 2.0, 3.0]
        assert _count(svc.act(OBS, session="s", reset=True)) == 1.0
        assert _count(svc.act(OBS)) == 1.0 and _count(svc.act(OBS)) == 1.0  # scratch, reset
        result = svc.act(OBS, session="s")
        assert _count(result) == 2.0 and result["batch_width"] == 2 and result["batch_rows"] == 1
    finally:
        svc.close()


def test_lru_eviction_is_deterministic():
    svc = _service(capacity=2)
    try:
        assert _count(svc.act(OBS, session="a")) == 1.0
        assert _count(svc.act(OBS, session="b")) == 1.0
        assert _count(svc.act(OBS, session="a")) == 2.0  # LRU order: b, a
        assert _count(svc.act(OBS, session="c")) == 1.0  # evicts b
        assert svc.sessions.sessions() == ["a", "c"]
        assert _count(svc.act(OBS, session="b")) == 1.0  # a new session; evicts a
        assert svc.sessions.sessions() == ["c", "b"]
        assert svc.sessions.created_total == 4 and svc.sessions.evictions_total == 2
        assert svc.sessions.drop("c") is True and svc.sessions.drop("c") is False
        assert _count(svc.act(OBS, session="d")) == 1.0 and svc.sessions.evictions_total == 2
    finally:
        svc.close()


def test_same_session_rows_never_share_a_dispatch():
    svc = _service(max_delay_ms=100.0)
    try:
        results = []
        threads = [threading.Thread(target=lambda: results.append(svc.act(OBS, session="one"))) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(_count(r) for r in results) == [1.0, 2.0, 3.0]
        assert len({r["dispatch_id"] for r in results}) == 3
    finally:
        svc.close()


def test_mixed_sessionless_rows_share_a_dispatch_without_contamination():
    svc = _service(max_delay_ms=150.0)
    try:
        for round_no in (1, 2, 3):
            barrier = threading.Barrier(3)
            results = {}

            def client(tag, session):
                barrier.wait()
                results[tag] = svc.act(OBS, session=session)

            threads = [threading.Thread(target=client, args=(tag, s)) for tag, s in (("s", "sess"), ("a", None), ("b", None))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert len({r["dispatch_id"] for r in results.values()}) == 1
            assert results["s"]["batch_width"] == 4 and results["s"]["batch_rows"] == 3
            assert _count(results["s"]) == float(round_no)
            assert _count(results["a"]) == 1.0 and _count(results["b"]) == 1.0
    finally:
        svc.close()


def test_batch_pinned_slab_overflows_to_scratch():
    store = SessionStore({"count": ((1,), "float32")}, capacity=1)
    idx, is_first, evicted = store.checkout(["a", "b"], [False, False], 4)
    assert idx.tolist() == [0, 1, 1, 1] and is_first.ravel().tolist() == [1.0, 1.0, 1.0, 1.0]
    assert store.overflow_total == 1 and evicted == []


def test_slab_step_scatters_in_place():
    handle = _counter_handle()
    store = SessionStore(handle.state_spec, capacity=3)
    slab_before = store.slab["count"]
    step = make_slab_step(handle.make_state_step(True))
    idx = torch.tensor([2, 0, 3, 3])
    actions = step({}, store.slab, idx, {}, torch.tensor([[1.0], [1.0], [1.0], [1.0]]), None)
    assert actions.ravel().tolist() == [1.0, 1.0, 1.0, 1.0]
    actions = step({}, store.slab, idx[:2], {}, torch.tensor([[0.0], [0.0]]), None)
    assert actions.ravel().tolist() == [2.0, 2.0]
    assert store.slab["count"] is slab_before
    assert store.slab["count"].ravel().tolist() == [2.0, 0.0, 2.0, 1.0]


# ---------------------------------------------------------------------------
# HTTP: the port's ServeApp on the CPU, the JAX server's wire format
# ---------------------------------------------------------------------------


def _post(url, payload, headers=None):
    req = urllib.request.Request(url + "/act", data=json.dumps(payload).encode(), headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read()), dict(err.headers)


def test_http_act_and_healthz_with_sessions_padding_and_eviction(tiny, tmp_path):
    run_dir = tmp_path / "run"
    (run_dir / "checkpoint").mkdir(parents=True)
    with open(run_dir / "config.yaml", "w") as fp:
        yaml.safe_dump(tiny["cfg"].as_dict(), fp)
    ckpt = run_dir / "checkpoint" / "ckpt_8_0.ckpt"
    from sheeprl_tpu_torch.utils.checkpoint import save_state

    save_state(str(ckpt), to_flax(*tiny["agent"]))
    cfg, ckpt_path, device = cli.serve_config(
        [f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serving.batch_buckets=[2,4]",
         "serving.sessions.capacity=2", "serving.max_delay_ms=1.0"]
    )
    app = ServeApp(cfg, ckpt_path, device)
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        assert app.service.warmup_steps == 4  # 2 buckets x 2 modes
        obs = {k: v[0].tolist() for k, v in _obs_np(1, seed=50).items()}
        for sid in ("a", "b", "a", "c", "b"):  # c evicts b, b returns and evicts a
            status, body, headers = _post(url, {"obs": obs, "session": sid}, {"X-Request-Id": f"req-{sid}"})
            assert status == 200, body
            assert headers["X-Request-Id"] == f"req-{sid}"
            action = np.asarray(body["action"])
            assert action.shape == (sum(ACTIONS_DIM),)
            assert np.allclose(action[:2].sum(), 1.0) and np.allclose(action[2:].sum(), 1.0)
            assert body["batch_width"] == 2 and body["batch_rows"] == 1 and body["ckpt_step"] == 8
        assert app.service.sessions.sessions() == ["c", "b"]
        status, body, _ = _post(url, {"obs": obs, "greedy": False})
        assert status == 200 and body["sessions_active"] == 2
        assert _post(url, {"obs": {"rgb": [1, 2]}})[0] == 400
        assert _post(url, {"obs": obs, "model": "other"})[0] == 404
        with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["algo"] == "dreamer_v3" and health["ckpt_step"] == 8
        assert health["models"]["default"]["sessions"] == {"active": 2, "capacity": 2, "evictions_total": 2}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/metrics", timeout=10)
    finally:
        app.close()

