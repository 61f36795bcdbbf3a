"""The port's ``MinedojoActor`` and ``algo.actor.cls`` held to the JAX
package's on the CPU (``sheeprl_tpu_torch/algos/dreamer_v3/agent.py``):
the hierarchical masks at the cases of ``tests/test_models/
test_minedojo_actor.py``, each sampled and greedy action against the JAX
actor's on the same params and the JAX key's own Gumbel draws; the masked
logits (-inf after the unimix transform); ``resolve_actor_cls`` in the
DreamerV1/V2/V3 and Plan2Explore builders, refusing a class that is not an
``Actor``; one masked player step against the JAX ``PlayerDV3``; two
DreamerV3 train steps with it from converted params against the JAX
``make_train_step``; and a tiny run on the MineDojo-shaped env of
``chip_smoke.py`` whose every player action its masks allow (the loop
passing the ``mask_*`` observations to the player).

Tolerances: actions compare exactly (one-hot, straight-through values
within 1e-6) where ``logits + noise`` separate the top two classes by more
than ``MARGIN``; the train steps as ``test_torch_dv3_train.py`` holds
them."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.algos.dreamer_v3.agent import Actor as JaxActor
from sheeprl_tpu.algos.dreamer_v3.agent import MinedojoActor as JaxMinedojoActor
from sheeprl_tpu.algos.dreamer_v3.agent import PlayerDV3 as JaxPlayerDV3
from sheeprl_tpu.algos.dreamer_v3.agent import _unimix as jax_unimix
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, MinedojoActor, PlayerDV3, _unimix, resolve_actor_cls
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state
from sheeprl_tpu_torch.interop.flax_params import _load, actor_spec, to_flax
from test_torch_dv3_train import B, MARGIN, T, _jax_noise, _leaves, _Setup
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ACTIONS_DIM = (19, 4, 6)
LATENT, ROWS = 8, 64
KW = dict(distribution="discrete", dense_units=16, mlp_layers=1, unimix=0.01)
MINEDOJO = "sheeprl_tpu.algos.dreamer_v3.agent.MinedojoActor"  # either package's name resolves in the port


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def actors():
    """The JAX MinedojoActor on perturbed params, and the port's on them."""
    jax_actor = JaxMinedojoActor(latent_state_size=LATENT, actions_dim=ACTIONS_DIM, is_continuous=False, **KW)
    params = jax.jit(jax_actor.init)(jax.random.PRNGKey(0), jnp.zeros((1, LATENT)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda a: (np.asarray(a) + 0.5 * rng.normal(size=a.shape)).astype(np.float32),
                                    params)
    actor = MinedojoActor(LATENT, ACTIONS_DIM, False, **KW)
    _load(actor_spec(actor), params, "", {})
    return jax_actor, params, actor


def _mask(rows, action_type=None, craft=None, equip_place=None, destroy=None):
    def allow(n, allowed):
        m = np.zeros((rows, n), bool)
        m[:, list(range(n) if allowed is None else allowed)] = True
        return m

    return {"mask_action_type": allow(19, action_type), "mask_craft_smelt": allow(4, craft),
            "mask_equip_place": allow(6, equip_place), "mask_destroy": allow(6, destroy)}


def _heads(actions):
    a = np.asarray(actions)
    return np.argmax(a[:, :19], -1), np.argmax(a[:, 19:23], -1), np.argmax(a[:, 23:], -1)


def _both(actors, mask, greedy=False, seed=3, cls=None):
    """Both packages' actions for ``ROWS`` latents under ``mask``: the JAX
    actor's from its key, the port's from that key's own Gumbel draws."""
    jax_actor, params, actor = actors
    if cls is not None:
        jax_actor, actor = cls
    latent = np.random.default_rng(seed).normal(size=(ROWS, LATENT)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jmask = None if mask is None else {k: jnp.asarray(v) for k, v in mask.items()}
    want = np.asarray(jax.jit(lambda p, x, k, m: jax_actor.apply(p, x, k, greedy, m, method="act"))(
        params, latent, key, jmask))
    noise = [_t(jax.random.gumbel(jax.random.fold_in(key, i), (ROWS, d))) for i, d in enumerate(ACTIONS_DIM)]
    with torch.no_grad():
        got = actor.act(_t(latent), None, greedy, None if greedy else noise,
                        None if mask is None else {k: _t(v.astype(np.float32)) for k, v in mask.items()})
        # the rows whose argmax the two packages' logits could split
        pre = actor(_t(latent))
        keep = np.ones(ROWS, bool)
        if not greedy:
            for head, n in zip(pre, noise):
                scores = np.sort((_unimix(head, head.shape[-1], actor.unimix) + n).numpy(), -1)
                keep &= ~np.isfinite(scores[:, -2]) | (scores[:, -1] - scores[:, -2] > MARGIN)
    assert keep.mean() > 0.9
    np.testing.assert_allclose(got.numpy()[keep], want[keep], atol=1e-6, rtol=0)
    return (*_heads(got.numpy()[keep]), keep)


def test_action_type_mask_restricts_head0(actors):
    i0, _, _, _ = _both(actors, _mask(ROWS, action_type=[0, 3, 7]))
    assert set(i0.tolist()) <= {0, 3, 7}


def test_craft_mask_applies_only_when_craft_is_taken(actors):
    i0, i1, _, _ = _both(actors, _mask(ROWS, action_type=[15], craft=[2]))
    assert (i0 == 15).all() and (i1 == 2).all()
    i0, i1, _, _ = _both(actors, _mask(ROWS, action_type=[0], craft=[2]))
    assert not set(i1.tolist()) <= {2}, "the craft mask must not constrain head 1 when the type is not craft"


@pytest.mark.parametrize("equip_or_place", [16, 17])
def test_equip_place_mask(actors, equip_or_place):
    i0, _, i2, _ = _both(actors, _mask(ROWS, action_type=[equip_or_place], equip_place=[1, 4]))
    assert (i0 == equip_or_place).all() and set(i2.tolist()) <= {1, 4}


def test_destroy_mask(actors):
    i0, _, i2, _ = _both(actors, _mask(ROWS, action_type=[18], destroy=[5], equip_place=[0]))
    assert (i0 == 18).all() and (i2 == 5).all()  # the destroy mask governs, the equip mask is not read


def test_a_mixed_mask_per_row(actors):
    """Each row its own masks, with the argument types allowed."""
    rng = np.random.default_rng(4)
    mask = {k: rng.random(v.shape) < 0.4 for k, v in _mask(ROWS).items()}
    for v in mask.values():
        v[np.arange(ROWS), rng.integers(0, v.shape[1], ROWS)] = True
    mask["mask_action_type"][:, 15:19] = True
    i0, i1, i2, keep = _both(actors, mask)
    m = {k: v[keep] for k, v in mask.items()}
    rows = np.arange(len(i0))
    assert m["mask_action_type"][rows, i0].all()
    assert m["mask_craft_smelt"][rows, i1][i0 == 15].all()
    assert m["mask_equip_place"][rows, i2][(i0 == 16) | (i0 == 17)].all()
    assert m["mask_destroy"][rows, i2][i0 == 18].all()
    assert {15, 16, 17, 18} & set(i0.tolist())


def test_masked_logits_are_neg_inf_after_unimix(actors):
    jax_actor, params, actor = actors
    mask = _mask(1, action_type=[15], craft=[0, 1])
    latent = np.ones((1, LATENT), np.float32)
    pre = jax_actor.apply(params, latent)
    logits = jax_unimix(pre[0], 19, 0.01)
    want = np.asarray(jax_actor.apply(params, 0, logits, None, {k: jnp.asarray(v) for k, v in mask.items()},
                                      method="_masked_logits_for_head"))
    with torch.no_grad():
        got_logits = _unimix(actor(_t(latent))[0], 19, 0.01)
        got = actor._masked_logits_for_head(0, got_logits, None, {k: _t(v) for k, v in mask.items()}).numpy()
    np.testing.assert_array_equal(np.isneginf(got), ~mask["mask_action_type"])
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = mask["mask_action_type"]
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[keep], got_logits.numpy()[keep], atol=0, rtol=0)  # untouched where allowed


def test_greedy_respects_masks(actors):
    i0, _, i2, _ = _both(actors, _mask(ROWS, action_type=[16], equip_place=[3]), greedy=True)
    assert (i0 == 16).all() and (i2 == 3).all()


def test_no_mask_acts_as_the_base_actor(actors):
    """Without masks MinedojoActor is ``Actor``: the same params, the same
    draws, the same actions, in both packages."""
    jax_actor, params, actor = actors
    base = Actor(LATENT, ACTIONS_DIM, False, **KW)
    base.load_state_dict(actor.state_dict())
    jax_base = JaxActor(latent_state_size=LATENT, actions_dim=ACTIONS_DIM, is_continuous=False, **KW)
    assert [h.tolist() for h in _both(actors, None)] == [h.tolist() for h in _both(actors, None,
                                                                                  cls=(jax_base, base))]


# ---------------------------------------------------------------------------
# algo.actor.cls in the builders
# ---------------------------------------------------------------------------


def _tiny(family: str, cls: str):
    return [f"exp={family}", "env=dummy", "env.id=discrete_dummy", f"algo.actor.cls={cls}", "algo.dense_units=8",
            "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.representation_model.hidden_size=8",
            "algo.world_model.transition_model.hidden_size=8", "algo.cnn_keys.encoder=[rgb]",
            "algo.cnn_keys.decoder=[rgb]", "algo.mlp_keys.encoder=[]", "algo.mlp_keys.decoder=[]",
            "env.capture_video=False", "metric.log_level=0", "env.screen_size=16"]


@pytest.mark.parametrize("family", ["dreamer_v3", "dreamer_v2", "dreamer_v1", "p2e_dv3_exploration",
                                    "p2e_dv2_exploration", "p2e_dv1_exploration"])
def test_actor_cls_selects_the_actor_in_every_builder(family):
    """The port builds a MinedojoActor where the JAX package builds one: the
    task actor of DreamerV1/V2/V3 and, through them, Plan2Explore's actors
    (the exploration actor is the task actor's class in the JAX package)."""
    from importlib import import_module

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose(_tiny(family, MINEDOJO) + (["algo.world_model.discrete_size=4"] if "v1" not in family else []))
    obs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8)})
    module = import_module(f"sheeprl_tpu_torch.algos.{family.replace('_exploration', '')}.agent")
    agent = module.build_agent(ACTIONS_DIM, False, cfg, obs, None, "cpu")
    actors = [getattr(agent, name) for name in ("actor", "actor_task", "actor_exploration") if hasattr(agent, name)]
    assert actors and all(isinstance(a, MinedojoActor) for a in actors), [type(a) for a in actors]


def test_actor_cls_rejects_a_class_that_is_not_an_actor():
    from sheeprl_tpu.algos.dreamer_v3.agent import resolve_actor_cls as jax_resolve_actor_cls

    for name in ("sheeprl_tpu.algos.dreamer_v3.agent.Critic", "sheeprl_tpu_torch.algos.dreamer_v3.agent.Critic"):
        with pytest.raises(ValueError, match="Actor subclass"):
            resolve_actor_cls({"cls": name})
    with pytest.raises(ValueError, match="Actor subclass"):
        jax_resolve_actor_cls(type("C", (dict,), {"__getattr__": dict.__getitem__})(
            cls="sheeprl_tpu.algos.dreamer_v3.agent.Critic"))
    assert resolve_actor_cls({"cls": None}) is Actor and resolve_actor_cls({}) is Actor
    assert resolve_actor_cls({"cls": MINEDOJO}) is MinedojoActor


# ---------------------------------------------------------------------------
# the player and two train steps, DreamerV3 tiny
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return _Setup("multidiscrete_dummy", ACTIONS_DIM, False, [f"algo.actor.cls={MINEDOJO}"])


def test_a_masked_player_step_matches_the_jax_player(setup):
    agent = setup.agent()
    assert isinstance(agent.actor, MinedojoActor) and isinstance(setup.actor_def, JaxMinedojoActor)
    n = 6
    rng = np.random.default_rng(5)
    obs = {"rgb": (rng.integers(0, 256, (n, 3, 16, 16)) / 255.0 - 0.5).astype(np.float32),
           "state": rng.normal(size=(n, 10)).astype(np.float32)}
    mask = _mask(n, action_type=[15, 16, 18], craft=[1], equip_place=[2, 3], destroy=[4])
    jmask = {k: jnp.asarray(v) for k, v in mask.items()}
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    jax_player = JaxPlayerDV3(setup.wm_def, setup.actor_def, ACTIONS_DIM, n)
    jax_player.init_states(params["world_model"])
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_player.get_actions(params["world_model"], params["actor"],
                                             {k: jnp.asarray(v) for k, v in obs.items()}, key, mask=jmask))
    k1, k2 = jax.random.split(key)
    wm = setup.cfg.algo.world_model
    noise = {"representation": _t(jax.random.gumbel(k1, (n, wm.stochastic_size, wm.discrete_size))),
             "actor": [_t(jax.random.gumbel(jax.random.fold_in(k2, i), (n, d))) for i, d in enumerate(ACTIONS_DIM)]}
    player = PlayerDV3(agent.world_model, agent.actor, ACTIONS_DIM, n)
    player.init_states()
    got = player.get_actions({k: _t(v) for k, v in obs.items()}, None, False, noise,
                             {k: _t(v.astype(np.float32)) for k, v in mask.items()}).numpy()
    for g, w in zip(_heads(got), _heads(want)):
        np.testing.assert_array_equal(g, w)
    i0, i1, i2 = _heads(got)
    assert set(i0.tolist()) <= {15, 16, 18} and (i1[i0 == 15] == 1).all()
    assert set(i2[i0 == 16].tolist()) <= {2, 3} and (i2[i0 == 18] == 4).all()


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    actions = np.concatenate([np.eye(d)[rng.integers(0, d, (T, B))] for d in ACTIONS_DIM], -1)
    terminated, is_first = np.zeros((T, B, 1)), np.zeros((T, B, 1))
    terminated[2, 0], is_first[3, 0] = 1.0, 1.0
    return {"rgb": rng.integers(0, 256, (T, B, 3, 16, 16)) / 255.0 - 0.5, "state": rng.normal(size=(T, B, 10)),
            "actions": actions, "rewards": rng.normal(size=(T, B, 1)), "terminated": terminated, "is_first": is_first}


def test_two_train_steps_with_the_minedojo_actor_match_make_train_step(setup):
    """Training reads no masks: the JAX step and the port's from converted
    params, on one batch of 19/4/6-way actions and the JAX key's draws."""
    cfg, jax_cfg = setup.cfg, setup.jax_cfg
    opts = {k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients),
                           jax_instantiate(jax_cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: opts[k].init(params[k]) for k in opts}
    jax_step = jax_make_train_step(setup.wm_def, setup.actor_def, setup.critic_def, opts, jax_cfg,
                                   setup.actions_dim, False)
    moments = jax_dv3_utils.init_moments_state()
    agent = setup.agent()
    optimizers = make_optimizers(cfg, agent)
    step = make_train_step(agent, optimizers, cfg, False)
    state = init_moments_state()
    batch = {k: v.astype(np.float32) for k, v in _batch(11).items()}
    key = jax.random.PRNGKey(5)
    for i, tau in enumerate((1.0, 0.02)):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics = jax_step(
            params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, sub, jnp.float32(tau))[:4]
        state, metrics = step(state, {k: _t(v) for k, v in batch.items()}, tau, None, _jax_noise(setup, sub))
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}: {METRIC_ORDER}")
    want = _leaves({k: params[k] for k in ("world_model", "actor", "critic", "target_critic")})
    got = _leaves(to_flax(*agent))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)


# ---------------------------------------------------------------------------
# the loop on the MineDojo-shaped env
# ---------------------------------------------------------------------------


def test_a_run_on_the_minedojo_shaped_env_takes_only_allowed_actions(tmp_path, monkeypatch):
    """chip_smoke.py's MineDojo-shaped env at tiny widths through ``run``:
    the loop passes the ``mask_*`` observations to the player, and every
    action the player takes, in training and in the test episode, is one
    its masks allow."""
    import chip_smoke
    from sheeprl_tpu_torch import cli
    from test_torch_dv3_train import TINY

    monkeypatch.chdir(tmp_path)
    overrides = TINY + ["env.id=minedojo_dummy", "env.executor=sync", "env.num_envs=2", "fabric.accelerator=cpu",
                        f"algo.actor.cls={MINEDOJO}", "env.screen_size=64",
                        "algo.mlp_keys.encoder=[state,mask_action_type,mask_craft_smelt,mask_equip_place,"
                        "mask_destroy]", "algo.mlp_keys.decoder=[state]", "algo.learning_starts=16",
                        "algo.total_steps=24", "buffer.size=64", "metric.logger=null", "algo.replay_ratio=0.5"]
    with chip_smoke.minedojo_shaped_env() as recorder:
        out = cli.run(overrides)
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    assert len(recorder.checked) == out["player_steps"] * 2 + out["test_steps"] and out["test_steps"] > 0
    assert all(recorder.checked)
