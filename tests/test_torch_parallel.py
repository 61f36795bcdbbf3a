"""The port's data axis (``parallel/{mesh,dp,runtime}.py``) against the JAX
package's ``parallel`` modules on the suite's 8 virtual CPU devices.

The placement and shard order of ``Runtime(devices=N)``, with its one
departure from the JAX runtime (shards beyond the devices share one, where
JAX raises); ``stage``'s blocks against the JAX ``stage``'s per-device
shards; ``pmean_tree`` and ``all_gather_cat`` under ``run_shards`` against
``lax.pmean`` / ``lax.all_gather`` under ``shard_map``; the Moments
quantile over the gathered lambda values (``tests/test_parallel/
test_dp_sharding.py::test_dv3_moments_quantile_is_global``, ported); the
local sample sizes; the sharding audit; and each refusal: FSDP, more than
one node, one device for a decoupled loop (which runs at two), the device
ring over an env count the shards do not divide.  Every coupled family trains over shards
(tests/test_torch_parallel_{steps,loops,offline,dv3_family,dv2_family}.py).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sheeprl_tpu.parallel import dp as jax_dp
from sheeprl_tpu.parallel.mesh import make_mesh
from sheeprl_tpu.parallel.runtime import Runtime as JaxRuntime
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.parallel import dp
from sheeprl_tpu_torch.parallel.mesh import model_axis_size, placement, replicate, shard_along
from sheeprl_tpu_torch.parallel.runtime import Runtime
from test_torch_droq import bounded  # noqa: F401 (a fixture: both packages' continuous dummy env in [-1, 1])
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

N_DEV = 8
CPU = torch.device("cpu")


def _shard_map(fn, in_specs, out_specs):
    from sheeprl_tpu.parallel.compat import shard_map

    return jax.jit(shard_map(fn, mesh=make_mesh(n_devices=N_DEV), in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


# --- placement ----------------------------------------------------------------


def test_runtime_places_the_shards_in_order_and_is_one_process(capsys):
    with pytest.warns(UserWarning, match="cpu holds more than one shard"):
        runtime = Runtime(devices=3, accelerator="cpu")
    assert runtime.devices == [CPU] * 3 and runtime.device == CPU and runtime.world_size == 3
    assert runtime.global_rank == 0 and runtime.is_global_zero
    assert "3 shards: shard 0 -> cpu, shard 1 -> cpu, shard 2 -> cpu" in capsys.readouterr().out
    tree = {"a": torch.ones(2)}
    assert runtime.all_gather(tree) is tree and runtime.broadcast("x") == "x" and runtime.barrier() is None
    # one shard: no placement line, no warning; auto / -1: every device the CPU has (one)
    for devices in (1, "auto", -1, "-1"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            one = Runtime(devices=devices, accelerator="cpu")
        assert one.devices == [CPU] and one.world_size == 1
    assert capsys.readouterr().out == ""
    assert placement(4, "cpu") == [CPU] * 4 and model_axis_size() == 1
    with pytest.raises(ValueError, match="positive count"):
        Runtime(devices=0, accelerator="cpu")
    # no CUDA device and no fabric.accelerator=cpu: raises, as one device does
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            Runtime(devices=2)


def test_the_jax_runtime_raises_where_the_port_places_more_shards_than_devices():
    assert len(jax.devices()) == N_DEV
    with pytest.raises(ValueError, match="only 8 are available"):
        JaxRuntime(devices=16, accelerator="cpu")
    with pytest.warns(UserWarning, match="holds more than one shard"):
        runtime = Runtime(devices=16, accelerator="cpu")
    assert runtime.world_size == 16 and runtime.devices == [CPU] * 16


def test_replicas_are_copies_each_shard_its_own():
    module = torch.nn.Linear(3, 2)
    replicas = replicate({"m": module, "pair": [torch.nn.Linear(2, 2)]}, [CPU, CPU])
    assert replicas[0]["m"] is module and replicas[1]["m"] is not module
    assert dp.replicas_equal(replicas)
    with torch.no_grad():
        replicas[1]["pair"][0].weight[0, 0] += 1e-7  # one bit of one leaf
    assert not dp.replicas_equal(replicas)
    opts = [torch.optim.Adam(r["m"].parameters()) for r in replicas]
    for opt, r in zip(opts, replicas):
        r["m"](torch.ones(1, 3)).sum().backward()
        opt.step()
    assert dp.replicas_equal([[r["m"], o] for r, o in zip(replicas, opts)])


# --- staging --------------------------------------------------------------------


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_stage_gives_shard_d_the_block_the_jax_stage_puts_on_device_d(batch_axis):
    rng = np.random.default_rng(0)
    shape = (3, 16, 5) if batch_axis == 1 else (16, 2, 3)
    tree = {"x": rng.normal(size=shape).astype(np.float32),
            "y": {"z": rng.integers(0, 255, shape[:2] + (4,), dtype=np.uint8)}}
    mesh = make_mesh(n_devices=N_DEV)
    staged = jax_dp.stage(tree, mesh, batch_axis=batch_axis)
    ours = dp.stage(tree, [CPU] * N_DEV, batch_axis=batch_axis)
    assert len(ours) == N_DEV
    assert shard_along(tree, [CPU] * N_DEV, axis=batch_axis)[3]["x"].equal(ours[3]["x"])
    for leaf, path in ((staged["x"], ("x",)), (staged["y"]["z"], ("y", "z"))):
        by_device = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        for d, device in enumerate(mesh.devices.reshape(-1)):
            mine = ours[d][path[0]] if len(path) == 1 else ours[d][path[0]][path[1]]
            assert mine.is_contiguous() and mine.device == CPU
            np.testing.assert_array_equal(mine.numpy(), by_device[device], err_msg=f"shard {d} {path}")
    # one shard: the batch as it is (a tensor on its device is not copied)
    t = torch.ones(4, 2)
    assert dp.stage({"t": t}, [CPU])[0]["t"] is t
    with pytest.raises(ValueError, match="cannot be cut into 3 equal shards"):
        dp.stage({"x": np.zeros((4, 2))}, [CPU] * 3)


def test_train_batches_prefetch_stages_each_step_into_the_shards_blocks():
    staged = []

    def stage_one(block, device):
        staged.append(int(block["x"][0, 0]))
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in block.items()}

    samples = [{"x": np.stack([np.arange(4) + 10 * i] * 2)} for i in range(3)]  # [T=2, B=4]
    order = []
    for batches in dp.train_batches(samples, [CPU, CPU], stage_one, batch_axis=1):
        order.append(len(staged))
        assert [b["x"][0].tolist() for b in batches] == [[b0, b0 + 1] for b0 in (batches[0]["x"][0, 0].item(),
                                                                                  batches[0]["x"][0, 0].item() + 2)]
    # the next step's two blocks were staged before the current step ran
    assert order == [4, 6, 6] and staged == [0, 2, 10, 12, 20, 22]
    assert list(dp.prefetch_staged([], lambda s: s)) == []


# --- collectives ------------------------------------------------------------------


def test_pmean_tree_and_all_gather_under_run_shards_match_shard_map():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N_DEV, 3, 2)).astype(np.float32)
    y = rng.normal(size=(N_DEV, 4)).astype(np.float32)

    def jax_body(x, y):
        return jax.lax.pmean({"x": x[0], "y": (y[0],)}, "data"), jax.lax.all_gather(y[0], "data")

    want_mean, want_gathered = _shard_map(jax_body, (P("data"), P("data")), (P(), P()))(x, y)

    def body(d):
        mean = yield from dp.pmean_tree({"x": torch.from_numpy(x[d]), "y": (torch.from_numpy(y[d]),)})
        gathered = yield from dp.all_gather_cat(torch.from_numpy(y[d]))
        return mean, gathered

    outs = dp.run_shards([body(d) for d in range(N_DEV)])
    for mean, gathered in outs:
        np.testing.assert_allclose(mean["x"].numpy(), np.asarray(want_mean["x"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mean["y"][0].numpy(), np.asarray(want_mean["y"][0]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(gathered.numpy(), np.asarray(want_gathered))
        # every shard holds the same bytes, each its own copy
        assert torch.equal(mean["x"], outs[0][0]["x"]) and torch.equal(gathered, outs[0][1])
    assert outs[1][0]["x"].data_ptr() != outs[0][0]["x"].data_ptr()
    # one shard: the operand itself
    single = torch.ones(2)
    assert dp.run_one(dp.pmean_tree(single)) is single and dp.run_one(dp.all_gather_cat(single)) is single


def test_run_shards_refuses_shards_that_leave_lockstep():
    def body(n):
        for _ in range(n):
            yield from dp.pmean_tree(torch.zeros(()))
        return n

    with pytest.raises(RuntimeError, match="1 of 2 shards returned"):
        dp.run_shards([body(1), body(2)])

    def other():
        yield from dp.all_gather_cat(torch.zeros(1))

    with pytest.raises(RuntimeError, match="different collectives"):
        dp.run_shards([body(1), other()])
    assert dp.run_shards([body(2), body(2)]) == [2, 2]


def test_dv3_moments_quantile_is_global():
    """The Moments EMA sees every shard's lambda values: with values disjoint
    across shards the quantiles are the global ones, as the JAX step's
    all-gathered quantile (``utils.py:213-215``)."""
    from sheeprl_tpu.algos.dreamer_v3.utils import update_moments as jax_update_moments
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import Behaviour
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state, update_moments

    x = np.concatenate([1000.0 * d + np.arange(100.0) for d in range(N_DEV)]).astype(np.float32)

    def jax_body(state, x):
        return jax_update_moments(state, x, decay=0.0, axis_name="data")[2]

    want = _shard_map(jax_body, (P(), P("data")), P())({"low": jnp.zeros(()), "high": jnp.zeros(())}, x)
    np.testing.assert_allclose(float(want["low"]), np.quantile(x, 0.05), rtol=1e-5)

    def body(d):
        local = torch.from_numpy(x[100 * d:100 * (d + 1)])
        gathered = yield from dp.all_gather_cat(local)
        return update_moments(init_moments_state(), gathered, decay=0.0)[2]

    for state in dp.run_shards([body(d) for d in range(N_DEV)]):
        np.testing.assert_allclose(float(state["low"]), float(want["low"]), rtol=1e-5)
        np.testing.assert_allclose(float(state["high"]), float(want["high"]), rtol=1e-5)
    # a shard's own values give its own quantile, not the global one
    own = update_moments(init_moments_state(), torch.from_numpy(x[:100]), decay=0.0)[2]
    assert float(own["high"]) < float(want["high"]) / 10
    # DreamerV3's step scales the advantage by the Moments of the gathered values
    behaviour = Behaviour(compose(["exp=dreamer_v3"]), is_continuous=True)
    local = torch.from_numpy(x[:100]).reshape(100, 1)
    _, moments = behaviour.advantage(init_moments_state(), local, torch.zeros_like(local),
                                     torch.from_numpy(x))
    ref = update_moments(init_moments_state(), torch.from_numpy(x), 0.99, 1.0, 0.05, 0.95)[2]
    assert torch.equal(moments["low"], ref["low"]) and torch.equal(moments["high"], ref["high"])


def test_shard_generators_draw_independent_streams_and_shard_0_draws_the_run_s():
    run = torch.Generator().manual_seed(5)
    gens = dp.shard_generators(run, 5, [CPU] * 3)
    assert gens[0] is run
    draws = [torch.rand(4, generator=g) for g in gens]
    assert not torch.equal(draws[1], draws[2]) and not torch.equal(draws[0], draws[1])
    again = dp.shard_generators(torch.Generator().manual_seed(5), 5, [CPU] * 3)
    assert all(torch.equal(d, torch.rand(4, generator=g)) for d, g in zip(draws, again))
    assert dp.fold_seed(5, 1) != dp.fold_seed(5, 2) != dp.fold_seed(6, 1)


def test_local_sample_sizes_are_the_global_batch_as_the_jax_single_process_draws():
    for global_batch in (4, 16, 30):
        for resident in (False, True):
            assert dp.local_sample_size(global_batch) == jax_dp.local_sample_size(global_batch, resident)
    # the off-policy loop draws per_rank_batch_size rows a shard at once
    from sheeprl_tpu_torch.algos.sac.sac import SACFamily
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose(["exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.hidden_size=8",
                   "algo.mlp_keys.encoder=[state]"])
    family = SACFamily(cfg, spaces.Dict({"state": spaces.Box(-20, 20, (10,), np.float32)}),
                       spaces.Box(-1.0, 1.0, (2,), np.float32), None, CPU).make_update()
    family.shard_over([CPU, CPU], torch.Generator().manual_seed(0), 0)
    drawn = []

    class _Buffer:
        def sample(self, batch_size, n_samples, sample_next_obs=False):
            drawn.append(batch_size)
            rng = np.random.default_rng(0)
            f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
            return {"observations": f(n_samples, batch_size, 10), "next_observations": f(n_samples, batch_size, 10),
                    "actions": rng.uniform(-1, 1, (n_samples, batch_size, 2)).astype(np.float32),
                    "rewards": f(n_samples, batch_size, 1), "terminated": np.zeros((n_samples, batch_size, 1),
                                                                                   np.float32)}

    family.stager = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    metrics = family.train(_Buffer(), 4, 2, torch.Generator().manual_seed(1), lambda d: d)
    assert drawn == [8] and torch.isfinite(metrics).all()
    assert dp.replicas_equal([[*s.modules(), s.optimizers] for s in family.shards])


# --- the sharding audit -------------------------------------------------------------


def test_the_sharding_audit_tables_the_replicas_and_the_batch_blocks():
    from sheeprl_tpu_torch.diagnostics.memory import MemoryMonitor, sharding_table

    replicas = replicate([torch.nn.Linear(64, 64)], [CPU, CPU])
    blocks = [{"obs": torch.zeros(4, 3)}, {"obs": torch.zeros(4, 3)}]
    table = sharding_table([CPU, CPU], {"params": replicas}, [blocks], top_n=2, replicated_warn_bytes=1024)
    assert table["n_shards"] == 2 and table["n_leaves"] == 4 and len(table["rows"]) == 2
    weight = table["rows"][0]
    assert weight["path"] == "params/0/weight" and weight["replicated"] and weight["n_devices"] == 2
    assert weight["bytes_per_device"] == 64 * 64 * 4 and weight["bytes"] == 2 * 64 * 64 * 4
    assert table["flagged_replicated"] == ["params/0/weight"] and "(fabric.fsdp)" in table["hint"]
    one = sharding_table([CPU], {"params": replicas[:1]}, [], replicated_warn_bytes=1024)
    assert one["flagged_replicated"] == [] and not one["rows"][0]["replicated"]
    # the monitor journals it once, at the first train dispatch, and its
    # digest reaches the breakdown and the summary
    events = []
    monitor = MemoryMonitor({"diagnostics": {"memory": {"replicated_warn_bytes": 1024}}})
    monitor.open(journal_fn=lambda event, **fields: events.append((event, fields)))
    assert monitor.summary()["sharding_audit"].startswith("not run")
    monitor.register_shards([CPU, CPU], {"params": replicas})

    class _Inst:
        name, kind = "train_step", "train"

    for _ in range(2):
        monitor.guarded_call(_Inst(), lambda: None, (blocks,), {})
    audits = [f for e, f in events if e == "sharding_audit"]
    assert len(audits) == 1 and audits[0]["fn"] == "train_step" and audits[0]["n_leaves"] == 4
    digest = monitor.summary()["sharding_audit"]
    assert digest["n_shards"] == 2 and digest["flagged_replicated"] == ["params/0/weight"]
    assert monitor.breakdown()["sharding_audit"] == digest


# --- refusals ----------------------------------------------------------------------

TINY_CPU = ["env=dummy", "env.capture_video=False", "fabric.accelerator=cpu", "metric.logger=null"]


def test_runtime_refuses_fsdp_and_more_than_one_node_by_their_roadmap_items():
    # FSDP is ported: an axis that divides the shards is taken, one that
    # does not is refused as the JAX runtime refuses it
    with pytest.warns(UserWarning, match="more than one shard"):
        assert Runtime(devices=2, fsdp=2, accelerator="cpu").fsdp == 2
    with pytest.raises(ValueError, match=r"fsdp axis size \(3\) must divide the device count \(2\)"):
        Runtime(devices=2, fsdp=3, accelerator="cpu")
    # more than one node is ported (tests/test_torch_multihost*.py): without
    # torchrun's variables the run is one process, with a warning, as the JAX
    # runtime runs without a coordinator
    with pytest.warns(UserWarning, match="num_nodes=2 without torchrun's variables.*one process"):
        assert Runtime(num_nodes=2, accelerator="cpu").process_count == 1


DECOUPLED_TINY = {
    "ppo_decoupled": ["env.id=discrete_dummy", "env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=4",
                      "algo.dense_units=8", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]",
                      "algo.total_steps=32", "checkpoint.every=16"],
    "sac_decoupled": ["env.id=continuous_dummy", "env.num_envs=2", "env.executor=sync", "algo.hidden_size=8",
                      "algo.per_rank_batch_size=4", "algo.mlp_keys.encoder=[state]", "algo.learning_starts=8",
                      "algo.total_steps=24", "buffer.size=32", "checkpoint.every=8"],
}


@pytest.mark.parametrize("exp", ["ppo_decoupled", "sac_decoupled"])
def test_the_decoupled_loops_are_refused_by_name(exp, tmp_path, monkeypatch, bounded):
    """The decoupled player/trainer loops run at ``fabric.devices=2`` (one
    player, one trainer shard) on the CPU; one device is refused by the
    algorithm's name, with the JAX ``check_configs``' error."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=f"Decoupled algorithm '{exp}' needs at least 2 devices"):
        cli.run([f"exp={exp}", *TINY_CPU, *DECOUPLED_TINY[exp], "fabric.devices=1"])
    out = cli.run([f"exp={exp}", *TINY_CPU, *DECOUPLED_TINY[exp], "fabric.devices=2", "algo.run_test=False"])
    assert out["shards"] == 2 and out["trainer_shards"] == 1 and out["replicas_equal"]
    assert len(out["metric_rows"]) > 0 and np.isfinite(out["metric_rows"]).all()
    assert all(promoted for _, promoted in out["gate"]) and len(out["handoff_ms"]) == len(out["gate"])
    assert out["checkpoints"] and out["player"] is not out["trainer"][0][0]


def test_the_device_ring_over_shards_is_refused_and_fabric_strategy_checked_as_jax_does(tmp_path, monkeypatch):
    """The env-sharded ring over an env count the shards do not divide:
    the factory falls back to the host buffer with the JAX factory's
    warning (the ring itself refuses it with the JAX ring's message,
    tests/test_torch_parallel_offline.py)."""
    from sheeprl_tpu.data.factory import make_dreamer_replay_buffer as jax_make_dreamer_replay_buffer
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
    from sheeprl_tpu_torch.data.factory import make_dreamer_replay_buffer

    monkeypatch.chdir(tmp_path)
    cfg = compose(["exp=dreamer_v3", *TINY_CPU, "fabric.devices=2", "buffer.device=True"])
    match = "needs the mesh and env.num_envs \\(3\\) divisible by the device count; falling back"
    with pytest.warns(UserWarning, match=match):
        rb, on_device = make_dreamer_replay_buffer(cfg, 3, str(tmp_path), 8, [CPU, CPU])
    assert not on_device and isinstance(rb, EnvIndependentReplayBuffer)
    with pytest.warns(UserWarning, match=match):
        assert not jax_make_dreamer_replay_buffer(cfg, 2, 3, ("state",), str(tmp_path), 8, mesh=make_mesh(n_devices=2))[1]
    cfg = compose(["exp=ppo", *TINY_CPU, "fabric.strategy=fsdp_native"])
    with pytest.warns(UserWarning, match="Unknown fabric.strategy 'fsdp_native'"):
        cli.check_configs(cfg)
    for strategy in ("auto", "dp", "ddp", "single"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cli.check_configs(compose(["exp=ppo", *TINY_CPU, f"fabric.strategy={strategy}"]))


@pytest.mark.parametrize("exp,overrides,match", [
    ("ppo", ["env.num_envs=1", "algo.rollout_steps=5"], "must be divisible by the number of devices \\(2\\)"),
    ("ppo", ["env.num_envs=2", "algo.rollout_steps=4", "algo.per_rank_batch_size=8"],
     "Per-device rollout \\(4\\) must be divisible by per_rank_batch_size \\(8\\)"),
    ("a2c", ["env.num_envs=1", "algo.rollout_steps=5"], "must be divisible by the number of devices \\(2\\)"),
    ("ppo_recurrent", ["env.num_envs=1", "algo.rollout_steps=12", "algo.per_rank_sequence_length=4"],
     "Number of sequences \\(3\\) must be divisible by the number of devices \\(2\\)"),
])
def test_the_on_policy_sizes_are_refused_over_the_shards_as_jax_refuses_them(exp, overrides, match, tmp_path,
                                                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=match):
        cli.run([f"exp={exp}", *TINY_CPU, "fabric.devices=2", "algo.mlp_keys.encoder=[state]",
                 "algo.cnn_keys.encoder=[]", *overrides])
