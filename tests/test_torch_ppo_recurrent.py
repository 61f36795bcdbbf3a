"""The port's recurrent PPO against the JAX package's, on the CPU at a tiny
width: the agent over a sequence with resets in the middle (actions,
log-probs, entropies, values and the final carry), one update with the
JAX permutations injected (discrete with a pixel key and the pre/post-LSTM
layers, continuous), the rollout's cut into sequences with their stored
initial states, the served session step against the JAX handle and the
player with two interleaved sessions and a reset, the converter, the
checkpoints crossing between the two packages' loops, and ``run`` with
resume, ``eval``, ``bf16-mixed`` and ``serve``.

Sampling takes the JAX draws injected: Gumbel noise ``fold_in(key, i)`` per
categorical head, a standard normal for the continuous head.  The JAX
package's own bit-exact session test fails on this CPU (ROADMAP.md Queue
3), so the session comparisons use tolerances.
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.ppo_recurrent.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.ops.numerics import gae as jax_gae
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, prev_actions_of
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import (
    METRIC_ORDER,
    RecurrentFamily,
    make_train_step,
    sequence_layout,
    to_sequences,
)
from sheeprl_tpu_torch.config import compose, instantiate
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.player import ObsStager, host_obs_slab
from sheeprl_tpu_torch.interop.flax_params import optax_state, optimizer_state_dict, ppo_recurrent_spec
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_dreamer_v2 import _state_leaves
from test_torch_dv3_train import _jit_build, _leaves, _t
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

SCREEN, HIDDEN = 36, 8
L, S = 4, 6  # sequence length, sequences
TINY = ["exp=ppo_recurrent", "env=dummy", "env.capture_video=False", f"env.screen_size={SCREEN}",
        "algo.dense_units=8", "algo.encoder.dense_units=8", "algo.encoder.cnn_features_dim=16",
        "algo.encoder.mlp_features_dim=6", f"algo.rnn.lstm.hidden_size={HIDDEN}", "algo.mlp_keys.encoder=[state]",
        "algo.update_epochs=2", f"algo.per_rank_sequence_length={L}", "algo.per_rank_num_batches=2",
        "algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.ent_coef=0.01", "seed=3"]
FAMILIES = {
    # multi-discrete heads over a pixel and a vector key, with the LSTM's
    # dense layers before and after it
    "discrete": ((2, 2), False, ["algo.cnn_keys.encoder=[rgb]", "algo.rnn.pre_rnn_mlp.apply=True",
                                 "algo.rnn.post_rnn_mlp.apply=True", "env.id=multidiscrete_dummy"]),
    "continuous": ((2,), True, ["algo.cnn_keys.encoder=[]", "env.id=continuous_dummy"]),
}


class _Setup:
    def __init__(self, family: str):
        self.actions_dim, self.continuous, extra = FAMILIES[family]
        overrides = TINY + extra
        self.jax_cfg, self.cfg = jax_compose(overrides), compose(overrides)
        self.cnn_keys = list(self.cfg.algo.cnn_keys.encoder)
        shapes = {"rgb": (3, SCREEN, SCREEN), "state": (10,)}
        keys = self.cnn_keys + ["state"]
        self.gym_obs = gym.spaces.Dict({k: gym.spaces.Box(0, 255, shapes[k], np.uint8) if k == "rgb"
                                        else gym.spaces.Box(-20, 20, shapes[k], np.float32) for k in keys})
        self.obs_space = spaces.Dict({k: spaces.Box(0, 255, shapes[k], np.uint8) if k == "rgb"
                                      else spaces.Box(-20, 20, shapes[k], np.float32) for k in keys})
        self.shapes = {k: shapes[k] for k in keys}

        def build():
            agent, params, _ = jax_build_agent(None, self.actions_dim, self.continuous, self.jax_cfg, self.gym_obs)
            return params, agent

        params, self.jax_agent = _jit_build(build)
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype), params)
        self.act_sum = int(sum(self.actions_dim))

    def agent(self, params=None):
        return build_agent(self.actions_dim, self.continuous, self.cfg, self.obs_space,
                           self.params if params is None else params, "cpu")

    def obs(self, lead, seed: int):
        rng = np.random.default_rng(seed)
        return {k: (rng.integers(0, 256, lead + s).astype(np.float32) if k == "rgb"
                    else rng.normal(size=lead + s).astype(np.float32)) for k, s in self.shapes.items()}

    def actions(self, lead, seed: int):
        rng = np.random.default_rng(seed)
        if self.continuous:
            return rng.normal(size=lead + (self.act_sum,)).astype(np.float32)
        return np.stack([rng.integers(0, d, lead) for d in self.actions_dim], -1).astype(np.float32)

    def noise(self, key, lead):
        if self.continuous:
            return _t(np.asarray(jax.random.normal(key, lead + (self.act_sum,))))
        return [_t(np.asarray(jax.random.gumbel(jax.random.fold_in(key, i), lead + (d,))))
                for i, d in enumerate(self.actions_dim)]


@pytest.fixture(scope="module")
def setups():
    return {}


def _setup(setups, family) -> _Setup:
    if family not in setups:
        setups[family] = _Setup(family)
    return setups[family]


def _inputs(setup, seed: int):
    rng = np.random.default_rng(seed)
    resets = np.zeros((L, S, 1), np.float32)
    resets[2, 1] = resets[1, 4] = 1.0  # episodes that start mid-sequence
    prev = prev_actions_of(torch.from_numpy(setup.actions((L, S), seed + 1)), setup.actions_dim,
                           setup.continuous).numpy()
    return {"obs": setup.obs((L, S), seed), "prev_actions": prev, "resets": resets,
            "hx": rng.normal(size=(S, HIDDEN)).astype(np.float32), "cx": rng.normal(size=(S, HIDDEN)).astype(np.float32)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_sequence_forward_with_resets_matches_the_jax_agent(family, setups):
    setup = _setup(setups, family)
    agent = setup.agent()
    x = _inputs(setup, 4)
    key = jax.random.PRNGKey(7)
    apply = jax.jit(lambda p, o, pa, h, c, r, k, a: setup.jax_agent.apply(p, o, pa, h, c, resets=r, key=k, actions=a))
    sample = jax.jit(lambda p, o, pa, h, c, r, k, g: setup.jax_agent.apply(p, o, pa, h, c, resets=r, key=k, greedy=g),
                     static_argnums=7)
    args = (x["obs"], x["prev_actions"], x["hx"], x["cx"], x["resets"])
    t_args = ({k: _t(v) for k, v in x["obs"].items()}, _t(x["prev_actions"]), _t(x["hx"]), _t(x["cx"]),
              _t(x["resets"]))
    with torch.no_grad():
        for greedy in (False, True):
            want = sample(setup.params, *args, key, greedy)
            got = agent(*t_args, greedy=greedy, noise=setup.noise(key, (L, S)))
            for g, w in zip(got[:4], want[:4]):
                assert g.shape == w.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
            for g, w in zip(got[4], want[4]):  # the final carry
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        # the given actions' log-probs and entropies, as the update takes them
        actions = setup.actions((L, S), 9)
        want = apply(setup.params, *args, key, actions)
        got = agent(*t_args, actions=_t(actions))
        for g, w in zip(got[1:4], want[1:4]):
            assert g.shape == w.shape and g.shape[-1] == 1
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _update_data(setup, seed: int):
    rng = np.random.default_rng(seed)
    x = _inputs(setup, seed)
    data = {"obs": x["obs"], "prev_actions": x["prev_actions"], "resets": x["resets"],
            "actions": setup.actions((L, S), seed + 2), "logprobs": rng.normal(size=(L, S, 1)) - 1.5,
            "values": rng.normal(size=(L, S, 1)), "returns": rng.normal(size=(L, S, 1)),
            "advantages": rng.normal(size=(L, S, 1)), "hx0": x["hx"], "cx0": x["cx"]}
    return {k: v if isinstance(v, dict) else v.astype(np.float32) for k, v in data.items()}


def _jax_update(setup):
    optimizer = optax.chain(optax.clip_by_global_norm(setup.jax_cfg.algo.max_grad_norm),
                            jax_instantiate(setup.jax_cfg.algo.optimizer))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return optimizer, jax_make_train_step(setup.jax_agent, optimizer, setup.jax_cfg, mesh, 2, S // 2)


def _jax_data(data):
    out = {**data["obs"], **{k: v for k, v in data.items() if k != "obs"}}
    out["hx0"], out["cx0"] = data["hx0"][None], data["cx0"][None]
    return {k: jnp.asarray(v) for k, v in out.items()}


def _port_data(data):
    return {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else _t(v)) for k, v in data.items()}


def _perms(key, epochs: int, n: int):
    return [_t(np.asarray(jax.random.permutation(k, n))) for k in jax.random.split(key, epochs)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_update_with_injected_permutations_matches_make_train_step(family, setups):
    setup = _setup(setups, family)
    optimizer, jax_step = _jax_update(setup)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_state = optimizer.init(params)
    data, key, coefs = _update_data(setup, 11), jax.random.PRNGKey(21), (0.2, 0.01, 0.5)
    params, opt_state, losses = jax_step(params, opt_state, _jax_data(data), key,
                                         tuple(jnp.float32(c) for c in coefs))
    agent = setup.agent()
    torch_opt = instantiate(setup.cfg.algo.optimizer)(agent.parameters())
    update = make_train_step(agent, torch_opt, setup.cfg, 2, S // 2)
    metrics = update(_port_data(data), _perms(key, 2, S), coefs)
    np.testing.assert_allclose(metrics[:3].numpy(), np.asarray(losses), atol=1e-5, rtol=1e-4)
    assert metrics[3] == 0  # no non-finite minibatch
    want, got = _leaves(params), _leaves(ppo_recurrent_spec_dump(agent))
    assert sorted(want) == sorted(got)
    for path, value in want.items():  # four adamw steps of at most lr 3e-4
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    adam = opt_state[1][0]
    mine = optax_state(torch_opt, ppo_recurrent_spec(agent))[1][0]
    for slot, tree in ((1, adam.mu), (2, adam.nu)):
        w, g = _leaves(tree), _leaves(mine.fields[slot])
        scale = max(float(np.abs(v).max()) for v in w.values())
        for path in w:
            np.testing.assert_allclose(g[path], w[path], atol=1e-4 * scale, rtol=1e-3, err_msg=path)


def test_anneal_lr_follows_optaxs_linear_schedule_over_the_updates(setups):
    """``algo.anneal_lr``: each minibatch update runs at optax's
    ``linear_schedule(lr, 0, total_iters * epochs * minibatches)`` of the
    updates before it, as the JAX loop's ``adamw`` evaluates it; and the
    optimizer's optax state carries the schedule's count."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_update

    setup = _setup(setups, "continuous")
    cfg = compose(TINY + FAMILIES["continuous"][2] + ["algo.anneal_lr=True", "env.num_envs=1",
                                                       f"algo.rollout_steps={L * S}"])
    agent = setup.agent()
    torch_opt = instantiate(cfg.algo.optimizer)(agent.parameters())
    total_iters = 3
    update = make_update(agent, torch_opt, cfg, total_iters)
    assert update.schedule and update.updates_per_iteration == 4
    rates = []
    step = torch_opt.step
    torch_opt.step = lambda: (rates.append(torch_opt.param_groups[0]["lr"]), step())[1]
    gen = torch.Generator().manual_seed(0)
    for iteration in range(1, 3):
        update(iteration, _port_data(_update_data(setup, 40 + iteration)), gen)
    lr = float(setup.jax_cfg.algo.optimizer.learning_rate)
    want = optax.linear_schedule(lr, 0.0, total_iters * 4)
    np.testing.assert_allclose(rates, [float(want(i)) for i in range(8)], rtol=1e-6, atol=0)
    assert rates[0] == pytest.approx(lr) and rates[-1] < rates[0]
    state = optax_state(torch_opt, ppo_recurrent_spec(agent), schedule=True)
    assert type(state[1][-1]).__name__ == "ScaleByScheduleState" and int(state[1][-1].fields[0]) == 8


def test_two_annealed_updates_match_the_jax_step(setups):
    """Two updates of two epochs of two minibatches with the learning rate
    annealed over 8 updates (to 0 at the last): the JAX chain of
    ``clip_by_global_norm`` and ``adamw(linear_schedule)`` and the port's."""
    from sheeprl_tpu_torch.algos.ppo.ppo import linear_schedule

    setup = _setup(setups, "discrete")
    lr = float(setup.jax_cfg.algo.optimizer.learning_rate)
    optimizer = optax.chain(optax.clip_by_global_norm(setup.jax_cfg.algo.max_grad_norm),
                            jax_instantiate(setup.jax_cfg.algo.optimizer,
                                            learning_rate=optax.linear_schedule(lr, 0.0, 8)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jax_step = jax_make_train_step(setup.jax_agent, optimizer, setup.jax_cfg, mesh, 2, S // 2)
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_state = optimizer.init(params)
    agent = setup.agent()
    torch_opt = instantiate(setup.cfg.algo.optimizer)(agent.parameters())
    update = make_train_step(agent, torch_opt, setup.cfg, 2, S // 2, linear_schedule(lr, 0.0, 8))
    coefs = (0.2, 0.01, 0.5)
    for call in range(2):
        data, key = _update_data(setup, 60 + call), jax.random.PRNGKey(70 + call)
        params, opt_state, losses = jax_step(params, opt_state, _jax_data(data), key,
                                             tuple(jnp.float32(c) for c in coefs))
        metrics = update(_port_data(data), _perms(key, 2, S), coefs)
        np.testing.assert_allclose(metrics[:3].numpy(), np.asarray(losses), atol=1e-5, rtol=1e-4)
    want, got = _leaves(params), _leaves(ppo_recurrent_spec_dump(agent))
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    assert int(opt_state[1][-1].count) == 8 == int(optax_state(torch_opt, ppo_recurrent_spec(agent),
                                                               schedule=True)[1][-1].fields[0])


def ppo_recurrent_spec_dump(agent):
    from sheeprl_tpu_torch.interop.flax_params import ppo_recurrent_to_flax

    return ppo_recurrent_to_flax(agent)


def test_the_rollout_is_cut_into_sequences_with_their_stored_initial_states(setups):
    """The rollout ``[T, N]`` -> ``[L, S]`` as the JAX loop cuts it
    (``ppo_recurrent.py:337-351``), GAE over it from the carry's value."""
    setup = _setup(setups, "continuous")
    cfg = compose(TINY + FAMILIES["continuous"][2] + ["env.num_envs=3", "algo.rollout_steps=8"])
    agent = setup.agent()
    rng = np.random.default_rng(5)
    T, N = 8, 3
    rb = ReplayBuffer(T, N)
    rows = {"state": rng.normal(size=(T, N, 10)), "actions": rng.normal(size=(T, N, 2)),
            "prev_actions": rng.normal(size=(T, N, 2)), "logprobs": rng.normal(size=(T, N, 1)),
            "values": rng.normal(size=(T, N, 1)), "rewards": rng.normal(size=(T, N, 1)),
            "dones": (rng.random((T, N, 1)) < 0.2), "resets": (rng.random((T, N, 1)) < 0.2),
            "hx": rng.normal(size=(T, N, HIDDEN)), "cx": rng.normal(size=(T, N, HIDDEN))}
    rb.add({k: v.astype(np.float32) for k, v in rows.items()})
    family = RecurrentFamily()
    carry = (torch.randn(N, HIDDEN), torch.randn(N, HIDDEN), torch.randn(N, 2))
    family.carry = (*carry, np.zeros((N, 1), np.float32))
    last_obs = {"state": rng.normal(size=(N, 10)).astype(np.float32)}
    stager = ObsStager("cpu")
    data = family.rollout_data(agent, rb, last_obs, lambda o, n: stager(host_obs_slab(o, [], ["state"], n)), cfg,
                               "cpu")
    # the JAX loop's own lines on the same rollout
    local = {k: rb.buffer[k][:T] for k in rb.buffer}
    next_values = setup.jax_agent.apply(setup.params, {"state": last_obs["state"][None]}, carry[2].numpy()[None],
                                        carry[0].numpy(), carry[1].numpy(), method="get_values")
    returns, advantages = jax_gae(jnp.asarray(local["rewards"]), jnp.asarray(local["values"]),
                                  jnp.asarray(local["dones"]), jnp.asarray(np.asarray(next_values)[0]), T, 0.99, 0.95)
    local["returns"], local["advantages"] = np.asarray(returns), np.asarray(advantages)

    def to_seq(x):
        chunks = T // L
        return x.reshape(chunks, L, N, *x.shape[2:]).swapaxes(1, 2).reshape(chunks * N, L, *x.shape[2:]).swapaxes(0, 1)

    for k in ("prev_actions", "actions", "logprobs", "values", "returns", "advantages", "resets"):
        np.testing.assert_allclose(data[k].numpy(), to_seq(local[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(data["obs"]["state"].numpy(), to_seq(local["state"]))
    np.testing.assert_array_equal(data["hx0"].numpy(), to_seq(local["hx"])[0])
    np.testing.assert_array_equal(data["cx0"].numpy(), to_seq(local["cx"])[0])
    assert data["actions"].shape == (L, T // L * N, 2)
    np.testing.assert_array_equal(to_sequences(torch.arange(24).reshape(8, 3), 4).numpy(),
                                  to_seq(np.arange(24).reshape(8, 3)))
    with pytest.raises(ValueError, match="multiple"):
        sequence_layout(compose(TINY + ["algo.rollout_steps=6"]))


def test_the_session_step_matches_the_jax_handle_and_the_player(setups):
    """Two interleaved sessions and a reset through the port's handle and
    the JAX package's, greedy and sampled; and the handle's state after it
    is the player's (the agent carried by hand, the carry masked on a new
    episode)."""
    from sheeprl_tpu.serving.loader import _ppo_recurrent_handle as jax_handle_of
    from sheeprl_tpu_torch.serving.loader import _ppo_recurrent_handle

    setup = _setup(setups, "discrete")
    jax_handle = jax_handle_of(setup.jax_cfg, setup.gym_obs, gym.spaces.MultiDiscrete([2, 2]), setup.params)
    handle = _ppo_recurrent_handle(setup.cfg, setup.obs_space, spaces.MultiDiscrete([2, 2]), setup.params, "cpu")
    assert handle.state_spec == jax_handle.state_spec and handle.action_shape == jax_handle.action_shape
    agent = setup.agent()
    for greedy in (True, False):
        jax_step = jax.jit(jax_handle.make_state_step(greedy))
        step = handle.make_state_step(greedy)
        zero = {k: np.zeros((2,) + shape, np.float32) for k, (shape, _) in handle.state_spec.items()}
        jstate, state = dict(zero), {k: _t(v) for k, v in zero.items()}
        carry = {"hx": torch.zeros(2, HIDDEN), "cx": torch.zeros(2, HIDDEN), "prev": torch.zeros(2, 4)}
        for rnd, is_first in enumerate(([1, 1], [0, 0], [0, 1], [0, 0])):
            obs = setup.obs((2,), 30 + rnd)
            first = np.asarray(is_first, np.float32)[:, None]
            key = jax.random.PRNGKey(rnd)
            want, jstate = jax_step(setup.params, jstate, obs, first, key)
            got, state = step(handle.params, state, {k: _t(v) for k, v in obs.items()}, _t(first), None,
                              setup.noise(key, (1, 2)))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
            for k in state:
                np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), atol=1e-5, err_msg=k)
            # the player: the rollout's reset and step
            keep = 1 - _t(first)
            with torch.no_grad():
                acts, _, _, _, (hx, cx) = agent({k: _t(v)[None] for k, v in obs.items()}, (carry["prev"] * keep)[None],
                                                carry["hx"] * keep, carry["cx"] * keep, greedy=greedy,
                                                noise=setup.noise(key, (1, 2)))
            carry = {"hx": hx, "cx": cx, "prev": prev_actions_of(acts[0], (2, 2), False)}
            np.testing.assert_allclose(acts[0].numpy(), got.numpy(), atol=0)
            np.testing.assert_allclose(carry["hx"].numpy(), state["hx"].numpy(), atol=1e-6)


def test_converter_round_trips_the_tree_and_the_adamw_state(setups):
    setup = _setup(setups, "discrete")
    agent = setup.agent()
    want, back = _leaves(setup.params), _leaves(ppo_recurrent_spec_dump(agent))
    assert sorted(back) == sorted(want) and any("OptimizedLSTMCell_0']['hf']['bias" in p for p in want)
    for path, value in want.items():
        assert back[path].dtype == value.dtype and np.array_equal(back[path], value), path
    optimizer = optax.chain(optax.clip_by_global_norm(0.5), jax_instantiate(setup.jax_cfg.algo.optimizer))
    state = optimizer.init(jax.tree_util.tree_map(jnp.asarray, setup.params))
    rng = np.random.default_rng(2)
    adam = state[1][0]
    state = (state[0], (adam._replace(count=jnp.asarray(5, jnp.int32),
                                      mu=jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), adam.mu),
                                      nu=jax.tree_util.tree_map(lambda a: rng.random(a.shape).astype(np.float32), adam.nu)),
                        *state[1][1:]))
    torch_opt = instantiate(setup.cfg.algo.optimizer)(agent.parameters())
    torch_opt.load_state_dict(optimizer_state_dict(jax.tree_util.tree_map(np.asarray, state), torch_opt,
                                                   ppo_recurrent_spec(agent)))
    got, want = _state_leaves(optax_state(torch_opt, ppo_recurrent_spec(agent))), _state_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a == b) if isinstance(b, str) else (a.dtype == b.dtype and np.array_equal(a, b))


LOOP = ["fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=8", "algo.total_steps=32", "metric.logger=null",
        "metric.log_every=16", "buffer.memmap=False", "checkpoint.every=16"]
RUN = TINY + FAMILIES["discrete"][2] + LOOP
# the JAX loop compiles in a fraction of the time without the pixel key
CROSS_RUN = TINY + FAMILIES["continuous"][2] + LOOP


def test_checkpoints_cross_between_the_two_packages_loops(setups, tmp_path, monkeypatch):
    """The JAX loop's checkpoint resumes a port run, and one update of each
    package from it agrees; the port's checkpoint passes the JAX
    ``verify_checkpoint`` and, restored as the JAX loop restores it, one
    update of each package agrees."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    monkeypatch.chdir(tmp_path)
    setup = _setup(setups, "continuous")
    optimizer, jax_step = _jax_update(setup)
    jax_run(CROSS_RUN + ["root_dir=jax_rppo", "algo.run_test=False"])
    ckpts = sorted(tmp_path.rglob("*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [int(p.name.split("_")[1]) for p in ckpts] == [16, 32]

    def one_update_each(path):
        jax_state, state = jax_load_state(path), load_state(path)
        assert {"agent", "opt_state", "iter_num", "policy_step", "batch_size"} <= set(state)
        params = jax.tree_util.tree_map(jnp.asarray, jax_state["agent"])
        opt_state = jax.tree_util.tree_map(lambda r, s: jnp.asarray(s, getattr(r, "dtype", None)),
                                           optimizer.init(params), jax_state["opt_state"])
        agent = setup.agent(state["agent"])
        torch_opt = instantiate(setup.cfg.algo.optimizer)(agent.parameters())
        torch_opt.load_state_dict(optimizer_state_dict(state["opt_state"], torch_opt, ppo_recurrent_spec(agent)))
        data, key, coefs = _update_data(setup, 13), jax.random.PRNGKey(4), (0.2, 0.01, 0.5)
        _, _, losses = jax_step(params, opt_state, _jax_data(data), key, tuple(jnp.float32(c) for c in coefs))
        metrics = make_train_step(agent, torch_opt, setup.cfg, 2, S // 2)(_port_data(data), _perms(key, 2, S), coefs)
        np.testing.assert_allclose(metrics[:3].numpy(), np.asarray(losses), atol=1e-5, rtol=1e-4)

    one_update_each(str(ckpts[0]))
    out = cli.run(CROSS_RUN + [f"checkpoint.resume_from={ckpts[0]}", "root_dir=port_resumed"])
    assert out["start_iter"] == 2 and out["iterations"] == 1 and np.isfinite(out["metric_rows"]).all()
    assert jax_verify_checkpoint(out["checkpoints"][-1]) == (True, "verified")
    one_update_each(out["checkpoints"][-1])


def test_run_trains_resumes_evaluates_serves_and_refuses_what_it_does_not_port(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.serving.server import PolicyService
    from sheeprl_tpu_torch.serving.loader import load_policy

    monkeypatch.chdir(tmp_path)
    out = cli.run(RUN + ["algo.run_test=True"])
    assert out["iterations"] == 2 and out["metric_rows"].shape == (2, len(METRIC_ORDER))
    assert np.isfinite(out["metric_rows"]).all() and np.isfinite(out["test_reward"])
    ckpt = out["checkpoints"][0]
    assert load_state(ckpt)["batch_size"] == sequence_layout(compose(RUN))[1]
    resumed = cli.run(RUN + [f"checkpoint.resume_from={ckpt}", "root_dir=resumed"])
    assert resumed["start_iter"] == 2 and resumed["iterations"] == 1
    assert np.isfinite(cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"]))
    mixed = cli.run(RUN + ["fabric.precision=bf16-mixed", "root_dir=mixed", "algo.total_steps=16"])
    assert np.isfinite(mixed["metric_rows"]).all()
    handle = load_policy(compose(RUN), ckpt, "cpu")
    service = PolicyService(handle, {"batch_buckets": [2], "max_delay_ms": 1.0, "sessions": {"capacity": 4}}).start()
    try:
        obs = {"rgb": np.zeros((3, SCREEN, SCREEN)).tolist(), "state": np.ones(10).tolist()}
        first = service.act(obs, greedy=True, session="a")
        again = service.act(obs, greedy=True, session="a", reset=True)
        assert np.asarray(first["action"]).shape == (2,)
        np.testing.assert_array_equal(first["action"], again["action"])
    finally:
        service.close()
    with pytest.raises(NotImplementedError, match="skip_update"):
        cli.run(RUN + ["diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=skip_update"])
    # algo.anneal_lr is ported: the run trains and checkpoints the schedule's count
    annealed = cli.run(RUN + ["algo.anneal_lr=True", "root_dir=annealed", "algo.total_steps=16"])
    assert np.isfinite(annealed["metric_rows"]).all()
    saved = load_state(annealed["checkpoints"][-1])["opt_state"]
    assert type(saved[1][-1]).__name__ == "ScaleByScheduleState"
