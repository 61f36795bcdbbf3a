"""The port's FSDP rule and its accounting against the JAX package's
``parallel/fsdp.py``, on the CPU.

The rule against the JAX ``shard_axis`` over a sweep of shapes, dtypes,
axis sizes and floors; ``shard_map_summary`` and ``tree_bytes_per_device``
against the JAX functions on a tiny DreamerV3's converted parameters and
optimizer state at axis 2 and 4 (the JAX trees placed on a ``(1, k)`` mesh
of the suite's virtual devices); the shards' ``(data, model)`` layout; the
``check_configs`` and runtime refusals with the JAX messages; the sharding
audit's exemption and hint; and a run's ``fsdp_shard_map`` event rendered
alike by both packages' ``memory_report``.
"""

from __future__ import annotations

import importlib.util
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sheeprl_tpu.parallel import fsdp as jax_fsdp
from sheeprl_tpu.parallel.mesh import make_mesh
from sheeprl_tpu_torch.parallel import fsdp
from sheeprl_tpu_torch.parallel.mesh import mesh_position, model_axis_size
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = [np.float32, np.float16, np.int32, np.int64, np.uint8, np.float64]


@settings(max_examples=300, deadline=None)
@given(shape=st.lists(st.integers(0, 96), min_size=0, max_size=4), dtype=st.sampled_from(DTYPES),
       axis_size=st.integers(0, 9), floor=st.one_of(st.none(), st.integers(0, 1 << 16)))
def test_shard_axis_is_the_jax_rule(shape, dtype, axis_size, floor):
    shape = tuple(shape)
    want = jax_fsdp.shard_axis(shape, dtype, axis_size, floor)
    assert fsdp.shard_axis(shape, dtype, axis_size, floor) == want
    # a torch leaf's dtype gives the same answer
    torch_dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    assert fsdp.shard_axis(shape, torch_dtype, axis_size, floor) == want


@pytest.fixture(scope="module")
def tiny_trees():
    """A tiny DreamerV3's converted parameters and optimizer state: the
    port's trees (as a checkpoint holds them) and the JAX package's."""
    import test_torch_dv3_train as dv3
    from sheeprl_tpu.config import instantiate as jax_instantiate
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, nest
    from sheeprl_tpu_torch.interop.flax_params import optax_state

    setup = dv3._Setup("multidiscrete_dummy", (2, 2), False)
    agent = setup.agent()
    optimizers = make_optimizers(setup.cfg, agent)
    port = {"params": agent.trees(),
            "opt_state": nest({k: optax_state(o, agent.optimizer_spec(k)) for k, o in optimizers.items()})}
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    opts = {k: optax.chain(optax.clip_by_global_norm(setup.jax_cfg.algo[k].clip_gradients),
                           jax_instantiate(setup.jax_cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    theirs = {"params": params, "opt_state": {k: opts[k].init(params[k]) for k in opts}}
    return port, theirs


@pytest.mark.parametrize("axis_size", [2, 4])
@pytest.mark.parametrize("floor", [256, None])
def test_shard_map_summary_and_bytes_per_device_are_the_jax_ones(tiny_trees, axis_size, floor):
    port, theirs = tiny_trees
    mesh = make_mesh(n_devices=axis_size, axis_names=("data", "model"), axis_sizes=(1, axis_size))
    ours = fsdp.shard_map_summary(port, axis_size, floor)
    assert ours == jax_fsdp.shard_map_summary(theirs, mesh, floor)
    if floor is not None:
        assert all(ours["trees"][t]["sharded"] > 0 for t in ("params", "opt_state"))
    for name in ("params", "opt_state"):
        placed = jax_fsdp.shard_tree(theirs[name], mesh, floor)
        assert fsdp.tree_bytes_per_device(port[name], axis_size, floor) == jax_fsdp.tree_bytes_per_device(placed)
        assert ours["trees"][name]["bytes_per_device"] == jax_fsdp.tree_bytes_per_device(placed)


def test_the_shards_sit_on_the_jax_mesh_layout():
    from sheeprl_tpu_torch.parallel.runtime import Runtime

    mesh = make_mesh(n_devices=8, axis_names=("data", "model"), axis_sizes=(2, 4))
    devices = list(jax.devices()[:8])
    for d in range(8):
        row, col = (int(i[0]) for i in np.nonzero(mesh.devices == devices[d]))
        assert mesh_position(d, 4) == (row, col)
    with pytest.warns(UserWarning, match="more than one shard"):
        runtime = Runtime(devices=8, fsdp=4, accelerator="cpu")
    assert model_axis_size(runtime) == 4 and model_axis_size() == 1
    assert fsdp.fsdp_active(4) and not fsdp.fsdp_active(1)


# ---------------------------------------------------------------------------
# the refusals: the JAX check_configs' and runtime's errors

REFUSED = {
    **{exp: [f"exp={exp}", "fabric.devices=2", "fabric.fsdp=2"]
       for exp in ("ppo", "a2c", "sac", "droq", "sac_ae", "dreamer_v2", "dreamer_v1", "ppo_recurrent",
                   "p2e_dv3_exploration", "p2e_dv2_exploration", "p2e_dv1_exploration")},
    "ppo_decoupled": ["exp=ppo_decoupled", "fabric.devices=4", "fabric.fsdp=2"],
    "sac_decoupled": ["exp=sac_decoupled", "fabric.devices=4", "fabric.fsdp=2"],
    "offline": ["exp=dreamer_v3", "fabric.devices=2", "fabric.fsdp=2", "algo.offline.enabled=true",
                "algo.offline.dataset_dir=nowhere"],
    "fsdp=3 on 2 devices": ["exp=dreamer_v3", "fabric.devices=2", "fabric.fsdp=3"],
    "fsdp=0": ["exp=dreamer_v3", "fabric.fsdp=0"],
    "floor -1": ["exp=dreamer_v3", "fabric.fsdp_min_shard_bytes=-1"],
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_check_configs_refuses_fsdp_as_the_jax_check_configs_does(case):
    from sheeprl_tpu.cli import check_configs as jax_check_configs
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose

    full = REFUSED[case] + ["env=dummy"]
    errors = {}
    for name, check, comp in (("port", cli.check_configs, compose), ("jax", jax_check_configs, jax_compose)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(Exception) as err:
                check(comp(full))
        errors[name] = err.value
    assert type(errors["port"]) is type(errors["jax"]) is ValueError
    assert str(errors["port"]) == str(errors["jax"])


@pytest.mark.parametrize("exp", ["dreamer_v3", "dreamer_v3_jepa"])
def test_check_configs_lets_the_dv3_family_through_as_the_jax_one_does(exp):
    from sheeprl_tpu.cli import check_configs as jax_check_configs
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose

    full = [f"exp={exp}", "env=dummy", "fabric.devices=4", "fabric.fsdp=2"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_check_configs(jax_compose(full))
        cli.check_configs(compose(full))


def test_the_runtime_refuses_an_axis_that_does_not_divide_the_shards_with_the_jax_message():
    from sheeprl_tpu.parallel.runtime import Runtime as JaxRuntime
    from sheeprl_tpu_torch.parallel.runtime import Runtime

    with pytest.raises(ValueError) as theirs:
        JaxRuntime(devices=8, accelerator="cpu", fsdp=3)
    with pytest.raises(ValueError) as ours:
        Runtime(devices=8, accelerator="cpu", fsdp=3)
    assert str(ours.value) == str(theirs.value) == "fsdp axis size (3) must divide the device count (8)"


# ---------------------------------------------------------------------------
# the sharding audit and the memory report


def test_the_sharding_audit_counts_slices_exempts_the_floor_and_hints_as_jax():
    from sheeprl_tpu.diagnostics.memory import sharding_table as jax_sharding_table
    from sheeprl_tpu_torch.diagnostics.memory import sharding_table
    from sheeprl_tpu_torch.parallel.mesh import replicate

    cpu = [torch.device("cpu")] * 2
    # a 64x64 weight the rule cuts, a 63x63 one it cannot (no even
    # dimension), a 32-wide bias under the floor
    modules = [torch.nn.Linear(64, 64), torch.nn.Linear(63, 63, bias=False), torch.nn.LayerNorm(32)]
    replicas = replicate(modules, cpu)
    opts = [fsdp.shard_optimizer(torch.optim.Adam([p for m in r for p in m.parameters()]), d, 2, 1024)
            for d, r in enumerate(replicas)]
    # between steps each shard's modules hold only their slices of the cut
    # parameters
    for opt in opts:
        fsdp.release_params([p for p, axis in zip(fsdp.layout_of(opt).params, fsdp.layout_of(opt).axes)
                             if axis is not None])
    for opt, r in zip(opts, replicas):
        for p in fsdp.layout_of(opt).params:
            p.grad = None
        for group in opt.param_groups:
            for v in group["params"]:
                v.grad = torch.ones_like(v)
        opt.step()
    table = sharding_table(cpu, {"params": replicas, "opt_state": opts}, [], replicated_warn_bytes=1024,
                           fsdp_axis_size=2, fsdp_min_shard_bytes=1024)
    rows = {r["path"]: r for r in table["rows"]}
    # Adam's moments of the cut weight: a slice on each shard, at its own bytes
    sliced = [r for p, r in rows.items() if p.startswith("opt_state") and r["shape"] == [32, 64]]
    assert len(sliced) == 2 and all(not r["replicated"] and r["bytes_per_device"] == 32 * 64 * 4 for r in sliced)
    # the cut weight itself: a slice on each shard's modules, at its own bytes
    assert not rows["params/0/weight"]["replicated"] and rows["params/0/weight"]["shape"] == [32, 64]
    assert rows["params/0/weight"]["bytes_per_device"] == 32 * 64 * 4
    # flagged: only the leaves over the floor the rule cannot cut (the 63x63
    # weight and its moments), with the JAX FSDP hint; never the bias under
    # the floor
    assert sorted(table["flagged_replicated"]) == ["opt_state/group0/2/exp_avg", "opt_state/group0/2/exp_avg_sq",
                                                  "params/1/weight"]
    from sheeprl_tpu.parallel.mesh import replicated_sharding

    mesh = make_mesh(n_devices=2, axis_names=("data", "model"), axis_sizes=(1, 2))
    weight = jax.device_put(np.zeros((63, 63), np.float32), replicated_sharding(mesh))
    jax_hint = jax_sharding_table(({"w": weight},), {}, replicated_warn_bytes=1024, fsdp_axis_size=2,
                                  fsdp_min_shard_bytes=1024).get("hint")
    assert table["hint"] == jax_hint
    assert "params/0/bias" not in table["flagged_replicated"]
    # without FSDP the hint names the knob the port acts on
    plain = sharding_table(cpu, {"params": replicas}, [], replicated_warn_bytes=1024)
    assert "params/0/weight" in plain["flagged_replicated"] and "(fabric.fsdp)" in plain["hint"]


def test_a_runs_fsdp_shard_map_renders_alike_in_both_memory_reports(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.tools import memory_report

    monkeypatch.chdir(tmp_path)
    out = cli.run(["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "fabric.accelerator=cpu",
                   "fabric.devices=2", "fabric.fsdp=2", "fabric.fsdp_min_shard_bytes=256", "metric.logger=null",
                   "algo.run_test=False", "env.num_envs=2", "env.executor=sync", "algo.dense_units=8",
                   "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=8",
                   "algo.world_model.representation_model.hidden_size=8",
                   "algo.world_model.transition_model.hidden_size=8", "algo.world_model.discrete_size=4",
                   "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]",
                   "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]", "algo.per_rank_batch_size=2",
                   "algo.per_rank_sequence_length=4", "algo.horizon=3", "algo.learning_starts=8",
                   "algo.total_steps=16", "buffer.size=32", "metric.log_every=8"])
    assert out["replicas_equal"] and out["gradient_steps"] > 0
    run_dir = str(out["log_dir"])
    spec = importlib.util.spec_from_file_location("root_memory_report", ROOT / "tools" / "memory_report.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    monkeypatch.setattr(sys, "argv", ["memory_report.py", run_dir])
    capsys.readouterr()
    want_rc, want = root.main(), capsys.readouterr()
    got_rc, got = memory_report.main([run_dir]), capsys.readouterr()
    assert (got_rc, got.out, got.err) == (want_rc, want.out, want.err)
    assert "fsdp shard map: axis_size=2 min_shard_bytes=256" in got.out and "[fsdp axis=2]" in got.out
    # the gauges the FSDP accounting adds, journaled with the interval's metrics
    import json

    metrics = [json.loads(line) for line in open(Path(run_dir) / "journal.jsonl")]
    gauges = [e["metrics"] for e in metrics if e["event"] == "metrics"]
    assert gauges and all(g.get("Telemetry/fsdp_axis_size") == 2.0 for g in gauges)
    # the parameter bytes a shard holds between steps: the rule's (the shard
    # map's bytes_per_device), below the whole tree's
    shard_map = next(e for e in metrics if e["event"] == "fsdp_shard_map")
    held = shard_map["trees"]["params"]["bytes_per_device"]
    assert shard_map["held_bytes_per_device"]["params"] == held < shard_map["trees"]["params"]["bytes"]
    assert shard_map["held_bytes_per_device"]["opt_state"] == shard_map["trees"]["opt_state"]["bytes_per_device"]
    assert all(g.get("Telemetry/params_bytes_per_device") == float(held) for g in gauges)
