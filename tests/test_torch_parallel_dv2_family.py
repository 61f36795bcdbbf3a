"""The port's two-shard gradient steps of DreamerV2, DreamerV1 and
Plan2Explore on them (exploration and finetuning) against the JAX
``make_train_step`` ``shard_map``-ed over two of the suite's virtual CPU
devices, and DreamerV2's two-shard checkpoints across the two packages.

For each family: two consecutive steps from converted params, the port's as
two shards (a replica of the agent and optimizers each, run in lockstep by
``parallel/dp.py::run_shards``) on the shards' blocks of one global batch
(shard d takes the sequences ``[d * B, (d + 1) * B)``), each shard's draws
injected from the JAX key as the JAX step folds it (``fold_in(key,
axis_index)``).  After each step the replicas hold the same bytes and shard
0's metrics agree with the JAX step's; after both, the parameters and every
optimizer's Adam moments.  The tolerances are each family's one-device
parity test's (metrics 1e-4, parameters 2e-6 absolute, Adam's moments 1e-4
of each tree's scale).  Every JAX two-device step is compiled once, at the
family's first use.

DreamerV2's port run at two shards writes a checkpoint that the JAX
``verify_checkpoint`` passes and the JAX loop resumes at two devices; that
JAX run's own checkpoint resumes in the port at two shards.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_dreamer_v1 as tv1
import test_torch_dreamer_v2 as tv2
import test_torch_p2e_dv1 as tp1
import test_torch_p2e_dv2 as tp2
from sheeprl_tpu.parallel.mesh import make_mesh
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers
from sheeprl_tpu_torch.parallel.dp import replicas_equal, run_shards, split
from sheeprl_tpu_torch.parallel.mesh import replicate
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_dv3_train import _leaves, _record_margins, _t
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

SHARDS = 2
CPU = ["cpu"] * SHARDS


def _mesh():
    return make_mesh(n_devices=SHARDS)


def _global_batch(batch_of, seed: int) -> dict:
    """Two blocks of the family's test batch, one a shard, along the batch
    axis."""
    blocks = [batch_of(seed + d) for d in range(SHARDS)]
    return {k: np.concatenate([b[k] for b in blocks], axis=1) for k in blocks[0]}


def _closure_key(fn):
    """What a nested function computes: its code and, recursively, what its
    closure holds (a function by its own key, anything else by identity)."""
    cells = tuple(_closure_key(c.cell_contents) if callable(getattr(c.cell_contents, "__code__", None))
                  else id(c.cell_contents) for c in (fn.__closure__ or ()))
    return fn.__code__, cells


class _jit_once:
    """``jax.jit`` of a function that computes what an earlier one computed
    returns the earlier compilation: the families' noise helpers jit a
    closure made anew at each call, and each compile costs a second or
    more."""

    def __init__(self, jit):
        self.jit, self.made = jit, {}

    def __call__(self, fn, *args, **kwargs):
        if args or kwargs or not hasattr(fn, "__code__"):
            return self.jit(fn, *args, **kwargs)
        key = _closure_key(fn)
        if key not in self.made:
            self.made[key] = (fn, self.jit(fn))  # the function kept: its ids stay taken
        return self.made[key][1]


def _two_steps(jax_step, params, opt_states, moments, agent, make_step, cfg, batch_of, noise_of, taus,
               metric_order, seed: int = 5, jax_metrics_of=None):
    """Two consecutive steps of the JAX two-device ``jax_step(params,
    opt_states, moments, batch, key, tau) -> (params, opt_states, moments,
    metrics)`` and of the port's two shards, each shard's ``make_step(agent,
    optimizers)`` on its replica; returns the JAX state and shard 0's
    agent, optimizers and Moments.  ``seed`` picks the batch and the key
    (one whose draws leave no near tie for the family's argmaxes);
    ``jax_metrics_of(jax_metrics)`` is what the port's metric vector holds
    of the JAX step's (all of it by default)."""
    replicas = replicate(agent, CPU)
    optimizers = [make_optimizers(cfg, r) for r in replicas]
    steps = [make_step(r, o) for r, o in zip(replicas, optimizers)]
    states = [agent.initial_moments("cpu") for _ in range(SHARDS)]
    batch = _global_batch(batch_of, 6 + seed)
    blocks = [{k: _t(np.ascontiguousarray(v)) for k, v in b.items()} for b in split(batch, SHARDS, 1)]
    key = jax.random.PRNGKey(seed)
    for i, tau in enumerate(taus):
        key, sub = jax.random.split(key)
        params, opt_states, moments, jax_metrics = jax_step(
            params, opt_states, moments, {k: jnp.asarray(v) for k, v in batch.items()}, sub, jnp.float32(tau))
        outs = run_shards([step.body(state, block, tau, None, noise_of(jax.random.fold_in(sub, d)))
                           for d, (step, state, block) in enumerate(zip(steps, states, blocks))])
        states = [state for state, _ in outs]
        metrics = outs[0][1]
        assert all(np.array_equal(m.numpy(), metrics.numpy()) for _, m in outs[1:])
        assert replicas_equal([[*r, *o.values()] for r, o in zip(replicas, optimizers)]), "the replicas diverged"
        want = np.asarray(jax_metrics) if jax_metrics_of is None else jax_metrics_of(jax_metrics)
        np.testing.assert_allclose(metrics.numpy(), want, atol=1e-4, rtol=1e-4, err_msg=f"step {i}: {metric_order}")
    return params, opt_states, moments, replicas[0], optimizers[0], states[0]


def _dv2_jax_step(make, *args):
    """A DreamerV2-shaped JAX step ``(params, opt_states, batch, key, tau)``
    in the uniform signature (the Moments pass through)."""
    step = make(*args, mesh=_mesh())

    def uniform(params, opt_states, moments, batch, key, tau):
        params, opt_states, metrics = step(params, opt_states, batch, key, tau)[:3]
        return params, opt_states, moments, metrics

    return uniform


def _dv1_jax_step(make, *args):
    """DreamerV1's JAX step ``(params, opt_states, batch, key)``, no tau."""
    step = make(*args, mesh=_mesh())

    def uniform(params, opt_states, moments, batch, key, tau):
        params, opt_states, metrics = step(params, opt_states, batch, key)[:3]
        return params, opt_states, moments, metrics

    return uniform


# ---------------------------------------------------------------------------
# the families


def _dreamer(built, version: int):
    """DreamerV2's or V1's setup (its one-device test's discrete case, on
    the vector observation: the CNN's compile would double the file's time)
    with its JAX step over two devices."""
    from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_dv1_make_train_step
    from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_step as jax_dv2_make_train_step

    if version == 2:
        s = built("dreamer_v2", lambda: tv2._Setup("discrete_dummy", (2,), False,
                                                   [*tv2.VECTOR_ONLY, "algo.world_model.use_continues=True"]))
        if not hasattr(s, "dp_step"):
            s.dp_step = _dv2_jax_step(jax_dv2_make_train_step, s.wm_def, s.actor_def, s.critic_def, s.opts,
                                      s.jax_cfg, s.actions_dim, s.is_continuous)
    else:
        s = built("dreamer_v1", lambda: tv1._Setup("discrete_dummy", False, tv1.VECTOR_ONLY))
        if not hasattr(s, "dp_step"):
            s.dp_step = _dv1_jax_step(jax_dv1_make_train_step, s.wm_def, s.actor_def, s.critic_def, s.opts, s.jax_cfg)
    return s


def _dreamer_family(built, version: int, finetuning: bool):
    """DreamerV2's or V1's two steps; with ``finetuning``, on the agent of
    the Plan2Explore finetuning loop (the task's trees and an exploration
    actor that only acts) at the same widths.  The JAX finetuning loops'
    step is DreamerV2's or V1's own (``sheeprl_tpu/algos/p2e_dv2/
    p2e_dv2_finetuning.py:25``, ``p2e_dv1/p2e_dv1_finetuning.py:28`` adapt
    its signature), so both cases hold the port to that one JAX step."""
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_train_step as make_dv1_train_step
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import METRIC_ORDER, make_train_step as make_dv2_train_step

    s = _dreamer(built, version)
    module, make_step = (tv2, make_dv2_train_step) if version == 2 else (tv1, make_dv1_train_step)
    agent = s.agent()
    if finetuning:
        ft = {2: tp2, 1: tp1}[version].ft
        explorer = ft.build_agent(s.actions_dim, s.is_continuous, s.cfg, s.obs_space, None, "cpu")
        agent = ft.build_agent(s.actions_dim, s.is_continuous, s.cfg, s.obs_space,
                               {**s.params, "actor_exploration": explorer.trees()["actor_exploration"]}, "cpu")
        acting = _leaves(agent.trees()["actor_exploration"])
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    opt_states = {k: s.opts[k].init(params[k]) for k in s.opts}
    params, opt_states, _, agent, optimizers, _ = _two_steps(
        s.dp_step, params, opt_states, {}, agent, lambda a, o: make_step(a, o, s.cfg, s.is_continuous), s.cfg,
        s.batch, s.noise, (1.0, 0.0) if version == 2 else (0.0, 0.0), METRIC_ORDER, seed=6)
    trees = agent.trees()
    if finetuning:  # the exploration actor only acts
        after = _leaves(trees.pop("actor_exploration"))
        assert all(np.array_equal(after[p], v) for p, v in acting.items())
    task = SimpleNamespace(trees=lambda: trees, optimizer_spec=agent.optimizer_spec)
    module._assert_trees_and_moments(params, opt_states, task, optimizers)


def _p2e_exploration(built, version):
    module = {2: tp2, 1: tp1}[version]
    s = built(f"p2e_dv{version}", lambda: module._Setup("discrete", tiny=module.TINY + module.VECTOR_ONLY))
    jax_ex = module.jax_ex
    if not hasattr(s, "dp_step"):
        s.dp_step = jax_ex.make_train_step(s.wm_def, s.actor_def, s.critic_def, s.optimizers, s.jax_cfg,
                                           s.actions_dim, s.is_continuous, mesh=_mesh())
    params = jax.tree_util.tree_map(jnp.asarray, s.params)
    _, opt_states = jax_ex._make_optimizers(s.jax_cfg, params, None)
    params, opt_states, _, agent, optimizers, _ = _two_steps(
        s.dp_step, params, opt_states, {}, s.agent(),
        lambda a, o: module.make_train_step(a, o, s.cfg, s.is_continuous), s.cfg, s.batch, s.noise, (1.0, 0.0),
        module.METRIC_ORDER, seed=6)
    module._assert_step_state(params, opt_states, agent, optimizers)


FAMILIES = {"dreamer_v2": lambda b: _dreamer_family(b, 2, False),
            "dreamer_v1": lambda b: _dreamer_family(b, 1, False),
            "p2e_dv2_exploration": lambda b: _p2e_exploration(b, 2),
            "p2e_dv2_finetuning": lambda b: _dreamer_family(b, 2, True),
            "p2e_dv1_exploration": lambda b: _p2e_exploration(b, 1),
            "p2e_dv1_finetuning": lambda b: _dreamer_family(b, 1, True)}


@pytest.fixture(scope="module")
def built():
    """Each family's setup (its JAX agent built once, its two-device step
    compiled at its first call), made at its first use."""
    made = {}

    def get(name, make):
        if name not in made:
            made[name] = make()
        return made[name]

    return get


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_shard_steps_match_the_jax_step_on_two_devices(family, built, monkeypatch):
    assert len(jax.devices()) >= SHARDS
    _record_margins(monkeypatch)
    monkeypatch.setattr(jax, "jit", _jit_once(jax.jit))
    FAMILIES[family](built)


# ---------------------------------------------------------------------------
# DreamerV2's two-shard checkpoints across the packages

RUN = [*tv2.TINY, *tv2.VECTOR_ONLY, "env.id=discrete_dummy", "fabric.accelerator=cpu", "env.num_envs=2", "metric.logger=null",
       "algo.run_test=False", "seed=3", "env.executor=sync", "algo.learning_starts=8", "algo.total_steps=32", "algo.replay_ratio=1",
       "buffer.size=32", "buffer.checkpoint=True", "checkpoint.every=8", "algo.per_rank_sequence_length=4",
       "algo.per_rank_batch_size=2"]


def test_a_two_shard_checkpoint_resumes_in_the_jax_loop_and_back(tmp_path, monkeypatch):
    """The port's two-shard checkpoint (shard 0's state, the global batch
    size) passes the JAX ``verify_checkpoint`` and resumes in the JAX loop at
    two devices (beside the JAX package's config of the run); the
    checkpoint that JAX run writes resumes in the port at two shards."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.resilience.manifest import verify_checkpoint as jax_verify_checkpoint
    from sheeprl_tpu.utils.utils import save_configs as jax_save_configs

    monkeypatch.chdir(tmp_path)
    out = cli.run(RUN + ["fabric.devices=2", "root_dir=port"])
    assert out["shards"] == 2 and out["replicas_equal"] and out["gradient_steps"] > 0
    ckpt = Path(out["checkpoints"][0])
    state = load_state(str(ckpt))
    assert state["batch_size"] == 2 * 2
    assert jax_verify_checkpoint(str(ckpt)) == (True, "verified")
    crossing = tmp_path / "crossing" / "version_0"
    (crossing / "checkpoint").mkdir(parents=True)
    jax_save_configs(jax_compose(RUN + ["fabric.devices=2", "root_dir=crossing"]), str(crossing))
    for path in ckpt.parent.glob(ckpt.name + "*"):
        shutil.copy(path, crossing / "checkpoint" / path.name)
    before = set(Path(".").rglob("ckpt_*.ckpt"))
    jax_run(RUN + ["fabric.devices=2", "root_dir=jax_resumed",
                   f"checkpoint.resume_from={crossing / 'checkpoint' / ckpt.name}"])
    jax_ckpts = sorted(set(Path(".").rglob("ckpt_*.ckpt")) - before, key=lambda p: int(p.name.split("_")[1]))
    assert jax_ckpts, "the JAX loop resumed from the port's checkpoint and wrote none"
    again = cli.run(RUN + ["fabric.devices=2", "root_dir=port_resumed", f"checkpoint.resume_from={jax_ckpts[0]}"])
    assert again["shards"] == 2 and again["replicas_equal"]
    assert again["start_iter"] == load_state(str(jax_ckpts[0]))["iter_num"] + 1
    assert len(again["metric_rows"]) > 0 and np.isfinite(again["metric_rows"]).all()
