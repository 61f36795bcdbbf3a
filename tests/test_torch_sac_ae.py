"""The port's SAC-AE held to the JAX package's on the CPU at a test width
(64x64 ``rgb`` and a 10-dim ``state``, features 8, 32-channel convolutions,
hidden 16, batch 4): the encoder (both branches, detached or not), the
decoder and ``preprocess_obs``; optax's state of the critic's Adam over
``(encoder, critic)`` and the decoder's ``adamw``, both ways; two
consecutive train calls of two gradient steps against the JAX
``make_train_step`` with its three draws a step, from the counter at 0 and
at 1 so that every gate opens and stays shut in turn (the metrics, all
seven trees, every optimizer's moments); the loop on the dummy env with its
action space bounded, its checkpoints read and resumed by the JAX package
and a JAX checkpoint resumed and evaluated here; ``serve`` refusing a
SAC-AE checkpoint; the options ``run`` refuses.

Tolerances: forward outputs 1e-5 (the conv stack sums 288-term windows in
another order than XLA); after the steps the metrics 1e-5 relative, the
parameters 2e-5 and Adam's moments 1e-4 of each tree's scale on the vector
branch; with pixels the gradients within 1e-5 of each leaf's scale, and the
two calls and one call from a trained checkpoint with the metrics within
1e-3 (the convolutions' ReLU kinks, see
``test_two_train_calls_with_pixels_track_the_jax_step``)."""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac_ae.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.sac_ae.utils import preprocess_obs as jax_preprocess_obs
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAEFamily, make_train_step
from sheeprl_tpu_torch.algos.sac_ae.utils import preprocess_obs
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_params import dump_trees, sac_ae_spec
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_droq import bounded  # noqa: F401 (a fixture)
from test_torch_sac import GYM_ACT, ACT_SPACE, check_moments, jit_build, leaves, perturb, torch_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TINY = ["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "env.frame_stack=1",
        "env.screen_size=64", "algo.hidden_size=16", "algo.dense_units=8", "algo.encoder.features_dim=8",
        "algo.per_rank_batch_size=4", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "seed=3"]
# the vector branch alone: the two-call step parity at tight tolerances
VECTOR = ["algo.cnn_keys.encoder=[]"]
GYM_OBS = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8),
                           "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
OBS_SPACE = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), np.uint8),
                         "state": spaces.Box(-20, 20, (10,), np.float32)})
G, B = 2, 4
NAMES = ("actor", "critic", "alpha", "encoder", "decoder")


class Setup:
    def __init__(self, overrides=TINY):
        self.cfg, self.jax_cfg = compose(overrides), jax_compose(overrides)

        def init():
            *defs, params, target_entropy = jax_build_agent(None, self.jax_cfg, GYM_OBS, GYM_ACT)
            return (*defs, target_entropy, params)

        defs, params = jit_build(init)
        self.encoder_def, self.decoder_def, self.actor_def, self.critic_def, self.target_entropy = defs
        params = perturb(params, scale=0.02)
        params["target_critic"] = perturb(params["critic"], 1, scale=0.02)
        params["target_encoder"] = perturb(params["encoder"], 2, scale=0.02)
        params["log_alpha"] = np.asarray([-0.4], np.float32)
        self.params = params

    def jax_optimizers(self):
        a = self.jax_cfg.algo
        return {name: jax_instantiate(a[name].optimizer) for name in NAMES}

    def jax_step(self):
        """The JAX ``make_train_step``, jitted once for this setup."""
        if not hasattr(self, "_jax_step"):
            self._jax_step = jax_make_train_step(self.encoder_def, self.decoder_def, self.actor_def, self.critic_def,
                                                 self.jax_optimizers(), self.jax_cfg, self.target_entropy)
        return self._jax_step

    def jax_init(self, params):
        opts = self.jax_optimizers()
        return {"actor": opts["actor"].init(params["actor"]),
                "critic": opts["critic"].init((params["encoder"], params["critic"])),
                "alpha": opts["alpha"].init(params["log_alpha"]), "encoder": opts["encoder"].init(params["encoder"]),
                "decoder": opts["decoder"].init(params["decoder"])}


class _Family(SACAEFamily):
    """The loop's family on given params, for its optimizers and specs."""

    def __init__(self, setup, agent_state, opt_states=None):
        state = {"agent": agent_state, **({"opt_states": opt_states} if opt_states is not None else {})}
        super().__init__(setup.cfg, OBS_SPACE, ACT_SPACE, state, "cpu")


@pytest.fixture(scope="module")
def setup():
    return Setup()


@pytest.fixture(scope="module")
def vector_setup():
    return Setup(TINY + VECTOR)


def _obs(seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 256, (*lead, 3, 64, 64)).astype(np.float32),
            "state": rng.normal(size=(*lead, 10)).astype(np.float32)}


def test_encoder_decoder_and_preprocess_match_the_jax_modules(setup):
    agent, _ = build_agent(setup.cfg, OBS_SPACE, ACT_SPACE, setup.params, "cpu")
    raw = _obs(1)
    obs = {"rgb": raw["rgb"] / 255.0, "state": raw["state"]}
    t_obs = torch_tree(obs)
    p = setup.params
    want = np.asarray(setup.encoder_def.apply(p["encoder"], obs))
    for detach in (False, True):
        got = agent.encoder(t_obs, detach_encoder_features=detach)
        assert got.shape == (B, 16)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    # detached: the gradient reaches the dense layers, not the convolutions or the vector stack
    agent.encoder(t_obs, detach_encoder_features=True).sum().backward()
    assert agent.encoder.convs[0].weight.grad is None and agent.encoder.mlp.dense[0].weight.grad is None
    assert agent.encoder.cnn_fc.weight.grad is not None and agent.encoder.mlp_fc.weight.grad is not None
    recon = setup.decoder_def.apply(p["decoder"], jnp.asarray(want))
    got = agent.decoder(torch.from_numpy(np.array(want)))
    assert got["rgb"].shape == (B, 3, 64, 64) and got["state"].shape == (B, 10)
    for k in ("rgb", "state"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(recon[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.uniform(key, raw["rgb"].shape))
    for bits in (5, 8):
        np.testing.assert_allclose(preprocess_obs(torch.from_numpy(raw["rgb"]), torch.from_numpy(noise), bits).numpy(),
                                   np.asarray(jax_preprocess_obs(raw["rgb"], key, bits)), atol=1e-6)
    back = leaves(dump_trees(sac_ae_spec(agent)))
    for path, value in leaves(p).items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def test_the_critic_and_decoder_optimizer_states_cross_both_ways(setup):
    """optax's Adam over the ``(encoder, critic)`` tuple and the decoder's
    ``adamw``: the port writes ``init``'s classes and trees, and reads the
    JAX states back into its optimizers."""
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    jax_states = setup.jax_init(params)
    assert [type(s).__name__ for s in jax_states["decoder"]] == ["ScaleByAdamState", "EmptyState", "EmptyState"]
    rng = np.random.default_rng(4)
    opts = setup.jax_optimizers()
    for name, tree in (("critic", (params["encoder"], params["critic"])), ("decoder", params["decoder"])):
        grads = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), tree)
        _, jax_states[name] = jax.jit(opts[name].update)(grads, jax_states[name], tree)
    family = _Family(setup, setup.params, jax.tree_util.tree_map(np.asarray, jax_states))
    ours = family.opt_states()
    for name in ("critic", "decoder"):
        assert [type(s).__name__ for s in ours[name]] == [type(s).__name__ for s in jax_states[name]]
        assert int(ours[name][0].fields[0]) == int(jax_states[name][0].count) == 1
        check_moments(ours[name], jax_states[name], rel=1e-6)
    assert isinstance(family.optimizers["decoder"], torch.optim.AdamW)
    assert family.optimizers["decoder"].defaults["weight_decay"] == 1e-7


def _noise(keys, data):
    """The JAX step's draws, in its split order: ``k_next, k_actor,
    k_noise``."""
    eps_next, eps_actor, pixels = [], [], []
    for g, key in enumerate(keys):
        k_next, k_actor, k_noise = jax.random.split(key, 3)
        eps_next.append(np.asarray(jax.random.normal(k_next, (B, 2))))
        eps_actor.append(np.asarray(jax.random.normal(k_actor, (B, 2))))
        pixels.append(np.asarray(jax.random.uniform(k_noise, data["rgb"][g].shape)))
    return {"eps_next": torch.from_numpy(np.stack(eps_next)), "eps_actor": torch.from_numpy(np.stack(eps_actor)),
            "pixels": {"rgb": torch.from_numpy(np.stack(pixels))}}


def _data(seed):
    rng = np.random.default_rng(seed)
    obs, nxt = _obs(seed, (G, B)), _obs(seed + 1, (G, B))
    return {**obs, **{f"next_{k}": v for k, v in nxt.items()},
            "actions": rng.uniform(-1, 1, (G, B, 2)).astype(np.float32),
            "rewards": rng.normal(size=(G, B, 1)).astype(np.float32),
            "terminated": (rng.random((G, B, 1)) < 0.3).astype(np.float32)}


class Steps:
    def __init__(self, setup, agent_state, jax_params, jax_opt_states, port_opt_states=None, counter=0):
        self.setup = setup
        self.family = _Family(setup, agent_state, port_opt_states)
        self.step = make_train_step(self.family.agent, self.family.optimizers, setup.cfg, -2.0)
        self.jax_step = setup.jax_step()
        self.params, self.opt_states = jax_params, jax_opt_states
        self.jax_counter, self.counter = jnp.int32(counter), counter

    def run(self, seed, rtol=1e-5):
        data = _data(seed)
        keys = jax.random.split(jax.random.PRNGKey(seed + 7), G)
        self.params, self.opt_states, self.jax_counter, jax_metrics = self.jax_step(
            self.params, self.opt_states, self.jax_counter, jax.tree_util.tree_map(jnp.asarray, data), keys)
        metrics, self.counter = self.step(torch_tree(data), _noise(keys, data), self.counter)
        assert self.counter == int(self.jax_counter)
        np.testing.assert_allclose(metrics.numpy()[:4], np.asarray(jax_metrics), rtol=rtol, atol=1e-6)
        assert metrics[4] == 0
        return np.asarray(jax_metrics)

    def check(self):
        got = leaves(dump_trees(sac_ae_spec(self.family.agent)))
        for path, value in leaves(self.params).items():
            value = np.asarray(value)
            np.testing.assert_allclose(got[path], value, atol=2e-5, rtol=1e-5, err_msg=path)
        ours = self.family.opt_states()
        for name in NAMES:
            assert int(ours[name][0].fields[0]) == int(self.opt_states[name][0].count), name
            check_moments(ours[name], self.opt_states[name])


def _grads(fn, tensors):
    return [g.numpy() for g in torch.autograd.grad(fn(), tensors)]


def test_the_losses_gradients_through_both_branches_match_jax(setup):
    """The critic's loss over ``(encoder, critic)`` and the reconstruction
    loss over ``(encoder, decoder)``, L2 penalty included: every gradient
    leaf within 1e-5 of its scale."""
    from sheeprl_tpu_torch.algos.sac.sac import spec_tensors

    agent, _ = build_agent(setup.cfg, OBS_SPACE, ACT_SPACE, setup.params, "cpu")
    spec, p = sac_ae_spec(agent), jax.tree_util.tree_map(jnp.asarray, setup.params)
    raw = _obs(5)
    obs = {"rgb": raw["rgb"] / 255.0, "state": raw["state"]}
    rng = np.random.default_rng(6)
    act, target = rng.uniform(-1, 1, (B, 2)).astype(np.float32), rng.normal(size=(B, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.uniform(key, raw["rgb"].shape))
    l2 = float(setup.cfg.algo.decoder.l2_lambda)

    def jax_critic(enc, critic):
        q = setup.critic_def.apply(critic, setup.encoder_def.apply(enc, obs), act)
        return jnp.sum(jnp.mean((q - target) ** 2, axis=0))

    def jax_rec(enc, dec):
        hidden = setup.encoder_def.apply(enc, obs)
        recon = setup.decoder_def.apply(dec, hidden)
        pen = l2 * jnp.mean(0.5 * jnp.sum(hidden**2, axis=-1))
        return (jnp.mean((jax_preprocess_obs(raw["rgb"], key, bits=5) - recon["rgb"]) ** 2) + pen
                + jnp.mean((raw["state"] - recon["state"]) ** 2) + pen)

    t_obs = torch_tree(obs)

    def port_critic():
        q = agent.critic(agent.encoder(t_obs), torch.from_numpy(act))
        return ((q - torch.from_numpy(target)) ** 2).mean(0).sum()

    def port_rec():
        hidden = agent.encoder(t_obs)
        recon = agent.decoder(hidden)
        pen = l2 * (0.5 * (hidden**2).sum(-1)).mean()
        pixels = preprocess_obs(torch.from_numpy(raw["rgb"]), torch.from_numpy(noise), 5)
        return (((pixels - recon["rgb"]) ** 2).mean() + pen
                + ((torch.from_numpy(raw["state"]) - recon["state"]) ** 2).mean() + pen)

    for jax_fn, port_fn, (a, b) in ((jax_critic, port_critic, ("encoder", "critic")),
                                    (jax_rec, port_rec, ("encoder", "decoder"))):
        want = jax.jit(jax.grad(jax_fn, argnums=(0, 1)))(p[a], p[b])
        tensors = spec_tensors(spec[a]) + spec_tensors(spec[b])
        grads = _grads(port_fn, tensors)
        with torch.no_grad():
            for t, g in zip(tensors, grads):
                t.copy_(torch.from_numpy(g))
        got = dump_trees({a: spec[a], b: spec[b]})
        want_leaves, got_leaves = leaves({a: want[0], b: want[1]}), leaves(got)
        for path, value in want_leaves.items():
            scale = float(np.abs(value).max())
            np.testing.assert_allclose(got_leaves[path], value, atol=1e-5 * scale, rtol=0, err_msg=path)
        agent, _ = build_agent(setup.cfg, OBS_SPACE, ACT_SPACE, setup.params, "cpu")
        spec = sac_ae_spec(agent)


@pytest.mark.parametrize("counter", [0, 1])
def test_two_train_calls_match_the_jax_step(vector_setup, counter):
    """Two calls of two gradient steps from the counter at ``counter``, on
    the vector branch: with the actor and target gates every 2 steps and
    the decoder's every step, each call opens the actor and target gates
    once; a skipped step reports the actor's and alpha's loss as 0."""
    s = vector_setup
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    steps = Steps(s, s.params, params, s.jax_init(params), counter=counter)
    for call in range(2):
        metrics = steps.run(10 + 10 * call)
        assert metrics[3] > 0
        steps.check()
    assert steps.counter == counter + 4


def test_two_train_calls_with_pixels_track_the_jax_step(setup):
    """The same with the pixel branch: the four convolutions' ReLUs hold
    some 4 x 10^5 units at batch 4, and a unit at its kink is on in one
    library and off in the other once the parameters differ by a rounding
    error; Adam (eps 1e-8) then moves a weight by a part of its step where
    the gradient is a rounding error.  So the metrics within 1e-3 relative
    and every parameter within one Adam step (lr 1e-3); the gradients
    themselves are held above, the step's arithmetic on the vector
    branch."""
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    steps = Steps(setup, setup.params, params, setup.jax_init(params))
    for call in range(2):
        steps.run(10 + 10 * call, rtol=1e-3)
    got = leaves(dump_trees(sac_ae_spec(steps.family.agent)))
    for path, value in leaves(steps.params).items():
        np.testing.assert_allclose(got[path], np.asarray(value), atol=1e-3, rtol=0, err_msg=path)


# --- the loop ----------------------------------------------------------------

RUN = ["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "env.executor=sync", "env.capture_video=False",
       "env.frame_stack=1", "fabric.accelerator=cpu", "env.num_envs=2", "algo.hidden_size=16", "algo.dense_units=8",
       "algo.encoder.features_dim=8", "algo.per_rank_batch_size=4", "algo.learning_starts=8",
       "algo.total_steps=16", "buffer.size=16", "buffer.checkpoint=True", "metric.logger=null",
       "metric.log_every=8", "checkpoint.every=8", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
       "seed=3"]


def _from_checkpoint(setup, ckpt):
    """One train call from a checkpoint in each package, restored as each
    loop restores it (the counter included)."""
    from sheeprl_tpu.utils.checkpoint import load_state as jax_load_state

    state = jax_load_state(ckpt)
    params = jax.tree_util.tree_map(jnp.asarray, state["agent"])
    opt_states = jax.tree_util.tree_map(lambda ref, saved: jnp.asarray(saved, dtype=getattr(ref, "dtype", None)),
                                        setup.jax_init(params), state["opt_states"])
    port_state = load_state(ckpt)
    steps = Steps(setup, port_state["agent"], params, opt_states, port_state["opt_states"],
                  counter=int(state["cumulative_counter"]))
    # the convolutions' kinks and a trained actor's saturated squash
    steps.run(80, rtol=1e-3)
    return state


def test_run_checkpoints_verify_and_resume_in_the_jax_package_and_serve_refuses_them(setup, tmp_path, bounded):
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu_torch.serving.server import ServeApp

    out = cli.run(RUN + [f"root_dir={tmp_path}", "algo.run_test=False"])  # eval plays the episode below
    assert len(out["checkpoints"]) == 2 and out["metric_rows"].shape[1] == 4
    assert np.isfinite(out["metric_rows"]).all() and (out["metric_rows"][:, 3] > 0).all()
    ckpt = out["checkpoints"][0]
    assert jax_verify_checkpoint(ckpt) == (True, "verified")
    state = _from_checkpoint(setup, ckpt)
    assert 0 < state["cumulative_counter"] < out["family"].counter == out["gradient_steps"]
    assert state["rb"]["buffer"]["rgb"].dtype == np.uint8
    assert np.isfinite(cli.evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "fabric.accelerator=cpu"]))
    cfg, path, device = cli.serve_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    with pytest.raises(ValueError, match="'sac_ae' has no servable adapter"):
        ServeApp(cfg, path, device)


def test_a_jax_checkpoint_resumes_and_evaluates_in_the_port(setup, tmp_path, monkeypatch, bounded):
    """On the vector branch: the JAX loop's jit of the pixel step takes
    most of a minute on the CPU, and the pixel trees cross from flax in
    every test above."""
    from sheeprl_tpu.cli import run as jax_run

    monkeypatch.chdir(tmp_path)
    run = RUN + VECTOR
    jax_run([o for o in run if o != "env.executor=sync"] + ["root_dir=jax_sac_ae", "algo.run_test=False"])
    ckpts = sorted(tmp_path.rglob("*.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [int(p.name.split("_")[1]) for p in ckpts] == [8, 16]
    out = cli.run(run + [f"checkpoint.resume_from={ckpts[0]}", "root_dir=port_resumed"])
    assert out["start_iter"] == 5 and out["policy_steps"] == 16 and np.isfinite(out["metric_rows"]).all()
    assert np.isfinite(cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"]))


@pytest.mark.parametrize("option", ["diagnostics.sentinel.policy=skip_update", "algo.offline.enabled=True",
                                    "model_manager.disabled=False"])
def test_run_refuses_what_it_does_not_port(tmp_path, option):
    extra = ["diagnostics.sentinel.enabled=True"] if "sentinel" in option else []
    if option == "algo.offline.enabled=True":
        # the offline mode drives sac, droq and dreamer_v3 only: the JAX gate
        with pytest.raises(ValueError, match=r"supports \['sac', 'droq', 'dreamer_v3'\], got algo.name='sac_ae'"):
            cli.run(RUN + extra + [option, f"root_dir={tmp_path}"])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.run(RUN + extra + [option, f"root_dir={tmp_path}"])

