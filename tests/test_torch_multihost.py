"""The port over two processes (``fabric.num_nodes > 1``), on the CPU: two
spawned interpreters join a gloo group on a free localhost port from
torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``), as ``parallel/runtime.py`` joins it.

The JAX package's own two-process tests are ``slow`` (its CPU backend has
no multiprocess collectives), so the port's multi-process step is held to
the port's one-process step at the same global shard count, which
``tests/test_torch_parallel_steps.py`` holds to the JAX step ``shard_map``-ed
over virtual devices.  Each rank checks the runtime's cross-process surface
as the JAX worker (``tests/test_parallel/_multihost_worker.py``) checks it:
``broadcast`` of an object, ``all_gather`` (and the rank-independent
aggregator's gather through it), ``barrier``, ``local_sample_size``
dividing by the process count; then one PPO update (injected permutations)
and two DreamerV3 train steps (the shards' random streams) at small widths
over 2 x 1 and 2 x 2 shards, each rank on its block of one global batch.
After each, every replica on every rank holds the bytes of every other and
of the one-process run with 2 or 4 shards on the same inputs and draws.

Run as a script, this module is one rank: ``python test_torch_multihost.py
<local shards> <out dir>`` with torchrun's variables set.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

PPO = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]",
       "algo.dense_units=8", "algo.mlp_layers=1", "algo.update_epochs=2", "seed=3"]
PPO_ROWS, PPO_MINIBATCHES = 8, 2  # a shard's rows and minibatches
DV3 = ["exp=dreamer_v3", "env=dummy", "algo.dense_units=8", "algo.mlp_layers=1",
       "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.representation_model.hidden_size=8",
       "algo.world_model.transition_model.hidden_size=8", "algo.world_model.discrete_size=4",
       "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]",
       "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]", "algo.per_rank_batch_size=2",
       "algo.horizon=3", "seed=3"]
DV3_T, DV3_B = 4, 2  # the sequence length and a shard's sequences
OBS = 10


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state_bytes(objs) -> list:
    """Every tensor of ``objs``' state (``dp.state_tensors``' order) as host bytes."""
    from sheeprl_tpu_torch.parallel.dp import state_tensors

    return [t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).clone() for t in state_tensors(objs)]


def ppo_update(devices, offset: int, shards: int) -> list:
    """One PPO update over this process's ``devices`` (global shards
    ``offset, ...`` of ``shards``), each on its rows of one global batch
    with its injected permutations: every local replica's state after it."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_train_step
    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.dp import run_shards
    from sheeprl_tpu_torch.parallel.mesh import replicate

    cfg = compose(PPO + [f"algo.per_rank_batch_size={PPO_ROWS // PPO_MINIBATCHES}"])
    obs_space = spaces.Dict({"state": spaces.Box(-20, 20, (OBS,), np.float32)})
    replicas = replicate(build_agent([3], False, cfg, obs_space, None, devices[0]), devices)
    optimizers = [instantiate(cfg.algo.optimizer)(r.parameters()) for r in replicas]
    steps = [make_train_step(r, o, cfg, PPO_MINIBATCHES, PPO_ROWS // PPO_MINIBATCHES)
             for r, o in zip(replicas, optimizers)]
    rng = np.random.default_rng(7)
    rows = shards * PPO_ROWS
    col = lambda: torch.from_numpy(rng.normal(size=(rows, 1)).astype(np.float32))  # noqa: E731
    data = {"obs": {"state": torch.from_numpy(rng.normal(size=(rows, OBS)).astype(np.float32))},
            "actions": torch.from_numpy(rng.integers(0, 3, (rows, 1)).astype(np.float32)), "logprobs": col() - 1.0,
            "values": col(), "returns": col(), "advantages": col()}
    bodies = []
    for i, (step, device) in enumerate(zip(steps, devices)):
        g = offset + i
        rows_of = slice(g * PPO_ROWS, (g + 1) * PPO_ROWS)
        block = {k: ({kk: vv[rows_of].to(device) for kk, vv in v.items()} if isinstance(v, dict)
                     else v[rows_of].to(device)) for k, v in data.items()}
        perms = [torch.from_numpy(np.random.default_rng([g, e]).permutation(PPO_ROWS)) for e in range(2)]
        bodies.append(step.body(block, perms, (0.2, 0.01, 0.5)))
    metrics = run_shards(bodies)
    return [_state_bytes([r, o]) for r, o in zip(replicas, optimizers)] + [[m.clone() for m in metrics]]


def dv3_steps(devices, offset: int, shards: int) -> list:
    """Two DreamerV3 train steps over this process's ``devices`` (global
    shards ``offset, ...`` of ``shards``), each on its sequences of one
    global batch with its random stream (``dp.shard_generators``): every
    local replica's state after each step."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.dp import run_shards, shard_generators
    from sheeprl_tpu_torch.parallel.mesh import replicate

    cfg = compose(DV3)
    obs_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (OBS,), np.float32)})
    replicas = replicate(build_agent((2,), True, cfg, obs_space, None, devices[0]), devices)
    optimizer_sets = [make_optimizers(cfg, r) for r in replicas]
    steps = [make_train_step(r, o, cfg, True) for r, o in zip(replicas, optimizer_sets)]
    generators = shard_generators(torch.Generator().manual_seed(5), 5, devices, offset)
    state = init_moments_state()
    out = []
    for it, tau in enumerate((1.0, 0.02)):
        rng = np.random.default_rng(11 + it)
        B = shards * DV3_B
        batch = {"state": rng.normal(size=(DV3_T, B, OBS)), "actions": np.clip(rng.normal(size=(DV3_T, B, 2)), -1, 1),
                 "rewards": rng.normal(size=(DV3_T, B, 1)), "terminated": np.zeros((DV3_T, B, 1)),
                 "is_first": np.zeros((DV3_T, B, 1))}
        bodies = []
        for i, (step, device, gen) in enumerate(zip(steps, devices, generators)):
            g = offset + i
            block = {k: torch.from_numpy(v[:, g * DV3_B:(g + 1) * DV3_B].astype(np.float32)).to(device)
                     for k, v in batch.items()}
            bodies.append(step.body({k: v.clone().to(device) for k, v in state.items()}, block, tau, gen))
        results = run_shards(bodies)
        state = results[0][0]
        out.append([_state_bytes([*r, *o.values()]) for r, o in zip(replicas, optimizer_sets)]
                   + [[m.clone() for _, m in results]])
    return out


def rank_main(local: int, out_dir: str) -> None:
    """One rank: the runtime's surface, then the steps; its replicas' state
    saved to ``<out_dir>/rank<r>.pt``."""
    torch.set_num_threads(1)
    from sheeprl_tpu_torch.parallel.dp import local_sample_size
    from sheeprl_tpu_torch.parallel.runtime import Runtime
    from sheeprl_tpu_torch.utils.metric import MeanMetric, RankIndependentMetricAggregator

    rank = int(os.environ["RANK"])
    rt = Runtime(devices=2 * local if local > 1 else "auto", num_nodes=2, accelerator="cpu")
    assert (rt.process_count, rt.global_rank, rt.is_global_zero) == (2, rank, rank == 0)
    assert rt.world_size == 2 * local and len(rt.devices) == local and rt.shard_offset == rank * local
    # the log-dir broadcast: every rank adopts rank 0's
    assert rt.broadcast(f"logs/runs/rank{rank}") == "logs/runs/rank0"
    assert rt.broadcast({"step": rank, "tree": [1, 2]}, src=1) == {"step": 1, "tree": [1, 2]}
    gathered = rt.all_gather(np.asarray([float(rank)], np.float32))
    np.testing.assert_array_equal(np.sort(np.asarray(gathered).ravel()), [0.0, 1.0])
    tensors = rt.all_gather({"x": torch.full((2,), float(rank))})
    assert torch.equal(tensors["x"], torch.tensor([[0.0, 0.0], [1.0, 1.0]]))
    aggregator = RankIndependentMetricAggregator(rt, {"Loss/x": MeanMetric()})
    aggregator.update("Loss/x", 10.0 * (rank + 1))
    assert aggregator.compute() == {"Loss/x": [10.0, 20.0]}
    rt.barrier()
    # each process draws its share of the global batch
    assert local_sample_size(8) == 4
    try:
        local_sample_size(7)
        raise AssertionError("local_sample_size(7) over two processes did not raise")
    except ValueError as err:
        assert "divisible by the process count (2)" in str(err)
    torch.save({"ppo": ppo_update(rt.devices, rt.shard_offset, rt.world_size),
                "dv3": dv3_steps(rt.devices, rt.shard_offset, rt.world_size)}, Path(out_dir) / f"rank{rank}.pt")
    rt.barrier()


def spawn_ranks(argv_of, cwd: str, timeout_s: float = 240.0, processes: int = 2, env: dict = None) -> list:
    """``processes`` interpreters, rank r running ``argv_of(r)``, with
    torchrun's variables for a free localhost port; their ``(exit code,
    output)``."""
    port = free_port()
    procs = []
    for r in range(processes):
        # the ranks share one host: gloo's interface is the loopback
        child_env = {**os.environ, **(env or {}), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                     "RANK": str(r), "WORLD_SIZE": str(processes), "GLOO_SOCKET_IFNAME": "lo",
                     "OMP_NUM_THREADS": "1",
                     "PYTHONPATH": os.pathsep.join([str(Path(__file__).resolve().parents[1]),
                                                    os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(argv_of(r), cwd=cwd, env=child_env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout_s)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


@pytest.fixture(scope="module")


def ranks(tmp_path_factory):
    """Both cases' ranks, started together: 2 x 1 and 2 x 2 shards."""
    roots = {local: tmp_path_factory.mktemp(f"multihost_{local}") for local in (1, 2)}
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(2) as pool:
        futures = {local: pool.submit(spawn_ranks, lambda r, root=root, local=local: [
            sys.executable, __file__, str(local), str(root)], str(root)) for local, root in roots.items()}
        results = {local: f.result() for local, f in futures.items()}
    for local, procs in results.items():
        for r, (code, text) in enumerate(procs):
            assert code == 0, f"rank {r} of 2 x {local}: exit {code}\n{text[-4000:]}"
    return {local: [torch.load(roots[local] / f"rank{r}.pt") for r in range(2)] for local in roots}



def _one_process(fn, shards: int):
    return fn([torch.device("cpu")] * shards, 0, shards)



def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))



def test_the_runtime_broadcasts_gathers_and_waits_across_processes(ranks):
    # the asserts ran in the ranks (rank_main); both exited 0 and wrote
    assert all(set(out) == {"ppo", "dv3"} for procs in ranks.values() for out in procs)

@pytest.mark.parametrize("local", [1, 2], ids=["2x1", "2x2"])


def test_a_ppo_update_over_processes_is_the_one_process_update_bitwise(ranks, local):
    want = _one_process(ppo_update, 2 * local)
    got = [replica for out in ranks[local] for replica in out["ppo"][:-1]]
    assert len(got) == 2 * local
    for g, replica in enumerate(got):
        assert _same(replica, want[g]), f"global shard {g}"
        assert _same(replica, got[0])
    for out in ranks[local]:
        assert all(torch.equal(m, want[-1][0]) for m in out["ppo"][-1])

@pytest.mark.parametrize("local", [1, 2], ids=["2x1", "2x2"])


def test_dv3_steps_over_processes_are_the_one_process_steps_bitwise(ranks, local):
    want = _one_process(dv3_steps, 2 * local)
    for step in range(2):
        got = [replica for out in ranks[local] for replica in out["dv3"][step][:-1]]
        assert len(got) == 2 * local
        for g, replica in enumerate(got):
            assert _same(replica, want[step][g]), f"step {step}, global shard {g}"
            assert _same(replica, got[0])
        for out in ranks[local]:
            assert all(torch.equal(m, want[step][-1][0]) for m in out["dv3"][step][-1])



def test_local_sample_size_draws_all_of_it_in_one_process():
    from sheeprl_tpu_torch.parallel.dp import local_sample_size

    assert local_sample_size(7) == 7



if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2])
