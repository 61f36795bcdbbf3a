"""The port's FSDP train step (``fabric.fsdp > 1``) against the JAX FSDP step
and against the port's own one-device step, on the CPU at a tiny width.

Two consecutive DreamerV3 steps from converted params: the JAX step on a
``(data, model) = (1, 2)`` mesh of the suite's virtual CPU devices, its
state placed by the partition rule (global view: it draws as one device
does), the port's as two shards in lockstep (``parallel/dp.py``), each
with its optimizers cut for its model index (``parallel/fsdp.py``), on
the shards' blocks of the same global batch (each shard's modules holding
only its slices between steps, gathered whole for a step), and the port's
one-device step on that whole batch.  The draws are injected: the JAX keys' draws at
the global batch's shapes, unfolded, each shard taking its block.  The
clips are set low, so that every update clips and a clip by a shard's own
slices' norm (rather than the whole gradient's) fails here.  Then the
same step with the run's one generator against the one-device step's
draws from it (``dp.global_streams``), and a tiny run of each other
family under ``fabric.fsdp=2``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_dv3_train as dv3
from sheeprl_tpu.algos.dreamer_v3 import utils as jax_utils
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.parallel import fsdp as jax_fsdp
from sheeprl_tpu.parallel.dp import stage as jax_stage
from sheeprl_tpu.parallel.mesh import make_mesh, replicated_sharding
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (METRIC_ORDER, learner_replicas_equal, make_optimizers,
                                                           make_train_step)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state
from sheeprl_tpu_torch.parallel.dp import global_streams, holding_whole, run_shards, split
from sheeprl_tpu_torch.parallel.fsdp import gathered_optimizers, layout_of, shard_replicas, whole_params
from sheeprl_tpu_torch.parallel.mesh import replicate
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

SHARDS = 2
CPU = [torch.device("cpu")] * SHARDS
MIN_SHARD = 256  # the tiny kernels' bytes: 8x8 fp32 and up shard, biases stay whole
CLIP = 1e-3  # below every norm of these steps: each update clips
OVERRIDES = ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]", f"algo.per_rank_batch_size={dv3.B}",
             f"fabric.fsdp_min_shard_bytes={MIN_SHARD}", *(f"algo.{k}.clip_gradients={CLIP}"
                                                        for k in ("world_model", "actor", "critic"))]


@pytest.fixture(scope="module")
def setup():
    s = dv3._Setup("continuous_dummy", (2,), True, OVERRIDES)
    jax_cfg = s.jax_cfg
    s.opts = {k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients),
                             jax_instantiate(jax_cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    s.mesh = make_mesh(n_devices=SHARDS, axis_names=("data", "model"), axis_sizes=(1, SHARDS))
    s.fsdp_step = jax_make_train_step(s.wm_def, s.actor_def, s.critic_def, s.opts, jax_cfg, s.actions_dim,
                                      s.is_continuous, mesh=s.mesh)
    return s


def _global_noise(setup, key, monkeypatch):
    """The JAX step's draws from ``key`` at the global batch's shapes."""
    with monkeypatch.context() as m:
        m.setattr(dv3, "B", SHARDS * dv3.B)
        return dv3._jax_noise(setup, key)


def _blocks_of(noise, T, B, shards):
    """Shard d's block of the global draws: rows ``[d * b, (d + 1) * b)`` of
    the dynamic scan's ``[T, B, ...]`` and of the ``T * B`` rows (``t * B +
    b``) of the imagination and the actor."""
    b = B // shards

    def rows(x, axis, d):
        y = x.reshape(*x.shape[:axis], T, B, *x.shape[axis + 1:]).narrow(axis + 1, d * b, b)
        return y.reshape(*x.shape[:axis], T * b, *x.shape[axis + 1:]).contiguous()

    return [{"dynamic": tuple(n[:, d * b:(d + 1) * b].contiguous() for n in noise["dynamic"]),
             "imagination": rows(noise["imagination"], 1, d),
             "actor": [[rows(h, 0, d) for h in heads] for heads in noise["actor"]]} for d in range(shards)]


def _fsdp_learner(setup, shards: int = SHARDS, fsdp: int = SHARDS):
    """The port's FSDP shards (``shards`` of them, a ``(shards / fsdp,
    fsdp)`` layout), as the loop places them (``fsdp.shard_replicas``):
    replicas of the converted agent, each's modules holding its model
    index's slices between steps and its optimizers cut for that index;
    their steps, each run with its parameters gathered whole for its length
    (``dp.holding_whole``); and the shards' cut parameters."""
    cfg = setup.cfg
    replicas = replicate(setup.agent(), [torch.device("cpu")] * shards)
    optimizer_sets, cut = shard_replicas(replicas, [make_optimizers(cfg, r) for r in replicas], fsdp, MIN_SHARD)
    steps = [make_train_step(r, o, cfg, setup.is_continuous) for r, o in zip(replicas, optimizer_sets)]
    return replicas, optimizer_sets, steps, cut


def _assert_trees(replicas, optimizer_sets, params, opt_states, moments, state, cut):
    """Parameters (2e-6, shard 0's joined from its row's slices), Adam
    (1e-4 of each tree's scale) and Moments (1e-5) of the port's shard 0
    against the reference's."""
    want = dv3._leaves({k: params[k] for k in ("world_model", "actor", "critic", "target_critic")})
    with whole_params(cut[:SHARDS], "cpu"):
        got = dv3._leaves(dv3.to_flax(*replicas[0]))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=2e-6, rtol=1e-5, err_msg=path)
    with gathered_optimizers(optimizer_sets) as whole:
        adam = dv3._adam_moments(replicas[0], whole)
    for name in ("world_model", "actor", "critic"):
        for slot, tree in (("exp_avg", opt_states[name]["exp_avg"]), ("exp_avg_sq", opt_states[name]["exp_avg_sq"])):
            w, g = dv3._leaves(tree), dv3._leaves(adam[name][slot])
            assert sorted(w) == sorted(g)
            scale = max(float(np.abs(v).max()) for v in w.values())
            for path in w:
                np.testing.assert_allclose(g[path], w[path], atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{path}")
    for k in ("low", "high"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(moments[k]), atol=1e-5, rtol=1e-5)


def test_two_fsdp_steps_match_the_jax_fsdp_step_and_the_one_device_step(setup, monkeypatch):
    two_fsdp_steps(setup, monkeypatch)


def two_fsdp_steps(setup, monkeypatch, between=None):
    """Two FSDP steps of the port's shards against the JAX FSDP step and
    the one-device step; ``between(replicas, cut)`` runs after each."""
    cfg = setup.cfg
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opt_states = {k: setup.opts[k].init(params[k]) for k in setup.opts}
    params = jax_fsdp.shard_tree(params, setup.mesh, MIN_SHARD)
    opt_states = jax_fsdp.shard_tree(opt_states, setup.mesh, MIN_SHARD)
    moments = jax.device_put(jax_utils.init_moments_state(), replicated_sharding(setup.mesh))

    replicas, optimizer_sets, steps, cut = _fsdp_learner(setup)
    # the rule cut some of every optimizer's parameters, and kept some whole
    for opt in optimizer_sets[0].values():
        axes = layout_of(opt).axes
        assert any(a is not None for a in axes) and any(a is None for a in axes)
    one = setup.agent()
    one_opts = make_optimizers(cfg, one)
    one_step = make_train_step(one, one_opts, cfg, setup.is_continuous)
    state, one_state = init_moments_state(), init_moments_state()

    dv3._record_margins(monkeypatch)
    batch = {k: np.concatenate([v, w], axis=1).astype(np.float32)
             for (k, v), w in zip(dv3._batch(setup, 11).items(), dv3._batch(setup, 12).values())}
    whole = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    blocks = split(whole, SHARDS, 1)
    key = jax.random.PRNGKey(5)
    for i, tau in enumerate((1.0, 0.02)):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics = setup.fsdp_step(
            params, opt_states, moments, jax_stage(batch, setup.mesh, batch_axis=1), sub, jnp.float32(tau))[:4]
        noise = _global_noise(setup, sub, monkeypatch)
        outs = run_shards([holding_whole(step.body({k: v.clone() for k, v in state.items()}, block, tau, None, n), c)
                           for step, block, n, c in zip(steps, blocks, _blocks_of(noise, dv3.T, SHARDS * dv3.B, SHARDS),
                                                        cut)])
        state, metrics = outs[0]
        one_state, one_metrics = one_step(one_state, whole, tau, None, noise)
        assert torch.equal(outs[1][1], metrics)
        assert learner_replicas_equal(replicas, optimizer_sets), "the model shards' gathered state diverged"
        if between is not None:
            between(replicas, cut)
        norms = metrics[METRIC_ORDER.index("Grads/world_model"):METRIC_ORDER.index("Grads/critic") + 1]
        assert (norms > CLIP).all(), f"step {i}: an update did not clip ({norms})"
        for ref, name in ((np.asarray(jax_metrics), "the JAX FSDP step"), (one_metrics.numpy(), "one device")):
            np.testing.assert_allclose(metrics.numpy(), ref, atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {i} against {name}: {METRIC_ORDER}")

    jax_adam = {k: {"exp_avg": opt_states[k][1][0].mu, "exp_avg_sq": opt_states[k][1][0].nu} for k in setup.opts}
    _assert_trees(replicas, optimizer_sets, params, jax_adam, moments, state, cut)
    _assert_trees(replicas, optimizer_sets, dv3.to_flax(*one), dv3._adam_moments(one, one_opts), one_state, state, cut)


@pytest.mark.parametrize("shards", [2, 4], ids=["(1, 2)", "(2, 2)"])
def test_an_fsdp_step_draws_the_one_device_steps_draws_from_one_generator(setup, shards):
    """Without injected noise: the shards draw from the run's one generator
    at the global shapes, each its block (``dp.global_streams``), so the
    step is the one-device step on the global batch; on one data row and on
    two (the gradients reduced over all four shards, the slices gathered
    within each row)."""
    cfg = setup.cfg
    replicas, optimizer_sets, steps, cut = _fsdp_learner(setup, shards)
    one = setup.agent()
    one_step = make_train_step(one, make_optimizers(cfg, one), cfg, setup.is_continuous)
    batch = {k: torch.from_numpy(np.concatenate([dv3._batch(setup, 11 + i)[k] for i in range(shards)],
                                                axis=1).astype(np.float32)) for k in dv3._batch(setup, 11)}
    blocks = split(batch, shards, 1)
    gen, one_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    state, one_state = init_moments_state(), init_moments_state()
    for tau in (1.0, 0.02):
        streams = global_streams(gen, [b["actions"].shape[1] for b in blocks])
        state, metrics = run_shards([
            holding_whole(step.body({k: v.clone() for k, v in state.items()}, block, tau, g), c)
            for step, block, g, c in zip(steps, blocks, streams, cut)])[0]
        one_state, one_metrics = one_step(one_state, batch, tau, one_gen)
        np.testing.assert_allclose(metrics.numpy(), one_metrics.numpy(), atol=1e-4, rtol=1e-4)
    # the generators stand where the one-device step left its own
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=one_gen))
    with whole_params(cut[:SHARDS], "cpu"):
        got = dv3._leaves(dv3.to_flax(*replicas[0]))
    want = dv3._leaves(dv3.to_flax(*one))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2e-6, rtol=1e-5, err_msg=path)
    assert learner_replicas_equal(replicas, optimizer_sets)


# ---------------------------------------------------------------------------
# every other family the JAX loop places under FSDP, in a tiny run

FSDP2 = ["fabric.devices=2", "fabric.fsdp=2", f"fabric.fsdp_min_shard_bytes={MIN_SHARD}", "fabric.accelerator=cpu",
         "metric.logger=null", "algo.run_test=False", "seed=3"]
WIDTHS = ["env=dummy", "env.capture_video=False", "env.screen_size=16", "algo.dense_units=8", "algo.mlp_layers=1",
          "algo.world_model.encoder.cnn_channels_multiplier=2",
          "algo.world_model.recurrent_model.recurrent_state_size=8",
          "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
          "algo.world_model.stochastic_size=4", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4",
          "algo.horizon=3", "algo.learning_starts=16", "algo.total_steps=24", "algo.replay_ratio=0.5",
          "buffer.size=64", "env.num_envs=2", "env.executor=sync"]
DISCRETE = ["algo.world_model.discrete_size=4"]
ENSEMBLES = ["algo.ensembles.n=3", "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1"]
EXPLORATION = ["buffer.checkpoint=True", "checkpoint.every=16"]
EXPLORE = {
    "dreamer_v3_jepa": ["exp=dreamer_v3_jepa_xs", *WIDTHS, *DISCRETE],
    "p2e_dv3_exploration": ["exp=p2e_dv3_exploration", *WIDTHS, *DISCRETE, *ENSEMBLES, *EXPLORATION],
    "p2e_dv2_exploration": ["exp=p2e_dv2_exploration", *WIDTHS, *DISCRETE, *ENSEMBLES, *EXPLORATION],
    "p2e_dv1_exploration": ["exp=p2e_dv1_exploration", *WIDTHS, *ENSEMBLES, *EXPLORATION],
}
FINETUNE = {"p2e_dv3_finetuning": "p2e_dv3_exploration", "p2e_dv2_finetuning": "p2e_dv2_exploration",
            "p2e_dv1_finetuning": "p2e_dv1_exploration"}


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """Each family's run at ``fabric.fsdp=2``, made at its first use through
    the loop's entry point (``cli.run_algorithm``: the JAX ``check_configs``
    refuses the Plan2Explore experiments' ``algo.name`` under FSDP, and so
    does the port's ``run``, ``tests/test_torch_fsdp.py``)."""
    from sheeprl_tpu_torch import cli

    root = tmp_path_factory.mktemp("fsdp_runs")
    made = {}

    def run(name, overrides):
        if name not in made:
            made[name] = cli.run_algorithm(cli.compose(overrides + FSDP2 + [f"root_dir={root / name}",
                                                                           f"run_name={name}"]))
        return made[name]

    run.root = root
    return run


@pytest.mark.parametrize("case", [*EXPLORE, *FINETUNE])
def test_each_family_takes_an_fsdp_step_and_journals_its_shard_map(case, family_runs, monkeypatch):
    import json
    from pathlib import Path

    monkeypatch.chdir(family_runs.root)
    if case in EXPLORE:
        overrides = EXPLORE[case]
    else:
        source = family_runs(FINETUNE[case], EXPLORE[FINETUNE[case]])
        overrides = [f"exp={case}", "env=dummy", "env.capture_video=False", "env.executor=sync",
                     "algo.replay_ratio=0.5", f"checkpoint.exploration_ckpt_path={source['checkpoints'][-1]}",
                     "buffer.load_from_exploration=True", "algo.per_rank_batch_size=2",
                     "algo.per_rank_sequence_length=4", "algo.learning_starts=8", "algo.total_steps=24",
                     "buffer.size=64"]
    out = family_runs(case, overrides)
    assert out["shards"] == 2 and out["replicas_equal"]
    assert out["gradient_steps"] > 0 and np.isfinite(out["metric_rows"]).all()
    events = [json.loads(line) for line in (Path(out["log_dir"]) / "journal.jsonl").read_text().splitlines()]
    maps = [e for e in events if e["event"] == "fsdp_shard_map"]
    assert len(maps) == 1 and maps[0]["axis_size"] == 2 and maps[0]["min_shard_bytes"] == MIN_SHARD
    assert all(maps[0]["trees"][t]["sharded"] > 0 for t in ("params", "opt_state"))


def test_skip_update_reverts_the_sliced_optimizer_state_under_fsdp(family_runs, monkeypatch):
    """A non-finite step under ``sentinel.policy=skip_update`` restores each
    model shard's slices (the guard snapshots the sliced optimizers), and
    the run trains on with the shards equal."""
    monkeypatch.chdir(family_runs.root)
    out = family_runs("dreamer_v3_skip_update", ["exp=dreamer_v3", *WIDTHS, *DISCRETE, "algo.total_steps=40",
                                                 "diagnostics=full", "diagnostics.sentinel.policy=skip_update",
                                                 "diagnostics.sentinel.inject_nan_iter=10", "metric.log_every=2"])
    rows = out["metric_rows"]
    bad = np.flatnonzero(~np.isfinite(rows).all(axis=1))
    assert len(bad) == 1 and bad[0] < len(rows) - 2 and np.isfinite(rows[bad[0] + 1:]).all()
    assert out["replicas_equal"] and out["gradient_steps"] > 0
