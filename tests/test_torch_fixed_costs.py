"""The fixed costs the card smoke no longer pays, each cut without a change
of result: a checkpoint file is hashed once a process (a byte rewritten
after its digest was kept still fails verification); the agent builds skip
torch's default initialisation where ``init_weights`` writes everything,
and their weights are bit for bit those of a default-initialised build; a
run's FLOPs are counted once a process for its widths and signature, and
the journaled ``telemetry_cost`` is the count of the first; the flax-layout
converter changes layouts with torch and gives the arrays the numpy
transforms gave."""

from __future__ import annotations

import contextlib
import importlib
import os
import time

import numpy as np
import pytest
import torch
from torch import nn

from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs.spaces import Box
from sheeprl_tpu_torch.resilience import manifest
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

# ---------------------------------------------------------------------------
# the digest kept a file
# ---------------------------------------------------------------------------


def _settled(path: str) -> None:
    """Wait until the file's last change is older than the memo's margin."""
    while time.time_ns() - max(os.stat(path).st_mtime_ns, os.stat(path).st_ctime_ns) <= manifest._SETTLED_NS:
        time.sleep(0.1)


def test_a_byte_rewritten_after_the_digest_was_kept_still_fails(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt_8_0.ckpt")
    manifest.save_verified_checkpoint(path, {"agent": {"w": np.arange(4096, dtype=np.float32)}, "policy_step": 8})
    # a fresh file's digest is not kept: a rewrite within the clock's
    # granularity would leave its stat as it was
    assert manifest.verify_checkpoint(path) == (True, "verified")
    assert not [k for k in manifest._DIGESTS if k[0] == os.path.realpath(path)]
    _settled(path)
    assert manifest.verify_checkpoint(path) == (True, "verified")
    assert [k for k in manifest._DIGESTS if k[0] == os.path.realpath(path)]
    # kept: the next verify reads no byte
    reads = []
    real_open = open
    monkeypatch.setattr("builtins.open", lambda f, *a, **k: reads.append(f) or real_open(f, *a, **k))
    assert manifest.verify_checkpoint(path) == (True, "verified") and str(path) not in reads
    monkeypatch.undo()
    with open(path, "r+b") as fp:
        fp.seek(100)
        byte = fp.read(1)
        fp.seek(100)
        fp.write(bytes([byte[0] ^ 0xFF]))
    assert manifest.verify_checkpoint(path) == (False, "digest_mismatch")
    assert manifest.newest_verified_checkpoint(str(tmp_path)) == (None, [{"path": path, "reason": "digest_mismatch"}])


def test_a_file_replaced_by_another_of_the_same_size_fails(tmp_path):
    path = str(tmp_path / "ckpt_8_0.ckpt")
    manifest.save_verified_checkpoint(path, {"w": np.zeros(1024, np.float32)})
    _settled(path)
    assert manifest.verify_checkpoint(path) == (True, "verified")
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 0x01
    tmp = path + ".new"
    with open(tmp, "wb") as fp:
        fp.write(data)
    os.replace(tmp, path)  # a new inode of the same size
    assert manifest.verify_checkpoint(path) == (False, "digest_mismatch")


# ---------------------------------------------------------------------------
# the agent builds
# ---------------------------------------------------------------------------

TINY = ["env.screen_size=16", "algo.dense_units=8", "algo.world_model.encoder.cnn_channels_multiplier=2",
        "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
        "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4", "algo.ensembles.n=2",
        "algo.ensembles.dense_units=8"]


@pytest.mark.parametrize("exp, state", [("dreamer_v3", None), ("dreamer_v3_jepa", None), ("p2e_dv3_exploration", None),
                                        ("p2e_dv3_finetuning", None), ("dreamer_v3", "policy")])
def test_agent_builds_are_bit_identical_to_a_default_initialised_build(exp, state, monkeypatch):
    """Each build against the same build with torch's default
    initialisation running first (the parent's): every tensor equal."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as dv3_agent
    from sheeprl_tpu_torch.algos.p2e_dv3 import agent as p2e_agent
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning
    from sheeprl_tpu_torch.utils.registry import find_algorithm

    cfg = compose([f"exp={exp}", "env=dummy", *[o for o in TINY if "ensembles" not in o or "p2e" in exp],
                   *(["checkpoint.exploration_ckpt_path=unread"] if "finetuning" in exp else [])])
    obs = {"rgb": Box(0, 255, (3, 16, 16), np.uint8)}
    family = importlib.import_module(find_algorithm(cfg.algo.name)["module"])

    def build():
        torch.manual_seed(0)
        if state == "policy":
            return dv3_agent.build_policy_modules([3], False, cfg, obs)
        return family.build_agent([3], False, cfg, obs, None, "cpu")

    built = build()
    for module in (dv3_agent, p2e_agent, p2e_dv3_finetuning):
        monkeypatch.setattr(module, "skip_default_init", contextlib.nullcontext, raising=False)
    reference = build()
    pairs = [(k, a, b) for m, r in zip(built, reference) for (k, a), (_, b) in zip(m.state_dict().items(),
                                                                                  r.state_dict().items())]
    assert len(pairs) == sum(len(m.state_dict()) for m in reference) > 10
    for key, a, b in pairs:
        assert torch.equal(a, b), key


def test_skip_default_init_is_checked_against_what_init_weights_writes():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import init_weights, skip_default_init, make_critic

    cfg = compose(["exp=dreamer_v3", "env=dummy", *TINY[:8]])
    with skip_default_init() as constructed:
        critic = make_critic(cfg)
        stray = nn.Linear(3, 3)  # built here, written by nobody
    assert any(t is stray.weight for t in constructed)
    with pytest.raises(RuntimeError, match="does not write"):
        init_weights(None, None, critic, torch.Generator().manual_seed(0), constructed=constructed)
    # without the stray layer every skipped tensor is written
    init_weights(None, None, critic, torch.Generator().manual_seed(0),
                 constructed=[t for t in constructed if t is not stray.weight and t is not stray.bias])


# ---------------------------------------------------------------------------
# the FLOP count kept a process
# ---------------------------------------------------------------------------

def test_telemetry_cost_is_the_first_runs_count(tmp_path, monkeypatch):
    """Three tiny DreamerV3 runs in one process: the second (other seed and
    depth, same widths) journals the first's FLOPs with ``count_s`` 0 and
    runs ``FlopCounterMode`` no more; the third, at another width, counts
    anew."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.diagnostics import telemetry
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from test_torch_dv3_train import RUN

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(telemetry, "_FLOPS_COUNTED", {})
    counted = []
    count_flops = telemetry.count_flops
    monkeypatch.setattr(telemetry, "count_flops", lambda call: counted.append(1) or count_flops(call))
    base = [o for o in RUN if o != "diagnostics=off"] + ["algo.run_test=False"]
    costs = []
    for i, extra in enumerate((["seed=1"], ["seed=2", "algo.total_steps=24"],
                               ["algo.world_model.recurrent_model.recurrent_state_size=16"])):
        out = cli.run(base + extra + [f"root_dir=run{i}"])
        events = read_journal(os.path.join(out["log_dir"], "journal.jsonl"))
        costs.append([(e["fn"], e["flops_per_call"], e["count_s"]) for e in events if e["event"] == "telemetry_cost"])
    assert len(counted) == 2
    (first,), (second,), (third,) = costs
    assert first[:2] == second[:2] and first[2] > 0 and second[2] == 0.0
    assert third[1] != first[1] and third[2] > 0


def test_the_step_cost_key_leaves_out_run_length_only():
    from sheeprl_tpu_torch.diagnostics.telemetry import step_cost_key

    base = compose(["exp=dreamer_v3", "env=dummy"])
    key = step_cost_key(base)
    for same in (["algo.total_steps=7"], ["algo.learning_starts=3"], ["algo.replay_ratio=0.5"], ["seed=9"],
                 ["checkpoint.every=3"], ["metric.log_every=1"]):
        assert step_cost_key(compose(["exp=dreamer_v3", "env=dummy", *same])) == key, same
    for other in (["algo.horizon=5"], ["fabric.precision=bf16-mixed"], ["algo.dense_units=64"],
                  ["diagnostics.health.enabled=False"], ["env.id=continuous_dummy"]):
        assert step_cost_key(compose(["exp=dreamer_v3", "env=dummy", *other])) != key, other


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def _numpy_to_flax(array, kind, hwc=()):
    """The numpy transforms the converter used before."""
    if kind == "dense":
        return array.T
    if kind == "dense_nhwc":
        h, w, c = hwc
        return array.T.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(h * w * c, -1)
    if kind == "dense_to_hwc":
        h, w, c = hwc
        return array.T.reshape(-1, c, h, w).transpose(0, 2, 3, 1).reshape(-1, h * w * c)
    if kind == "bias_hwc":
        h, w, c = hwc
        return array.reshape(c, h, w).transpose(1, 2, 0).reshape(-1)
    if kind == "conv":
        return array.transpose(2, 3, 1, 0)
    if kind == "conv_transpose":
        return array[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return array


@pytest.mark.parametrize("kind, shape, hwc", [
    ("dense", (7, 5), ()), ("dense_nhwc", (6, 24), (2, 3, 4)), ("dense_to_hwc", (24, 5), (2, 3, 4)),
    ("bias_hwc", (24,), (2, 3, 4)), ("conv", (4, 3, 2, 5), ()), ("conv_transpose", (3, 4, 2, 5), ()),
    ("same", (3, 3), ())])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_converter_gives_the_numpy_transforms_arrays(kind, shape, hwc, dtype):
    from sheeprl_tpu_torch.interop import flax_params

    meta = (hwc,) if hwc else ()
    tensor = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(dtype)
    want = np.ascontiguousarray(_numpy_to_flax(tensor.float().numpy(), kind, *meta))
    got = flax_params._flax_array(tensor, kind, *meta)
    assert got.dtype == np.float32 and got.flags.c_contiguous and np.array_equal(got, want)
    assert not np.shares_memory(got, tensor.float().numpy())
    back = flax_params._from_flax_array(want, kind, *meta)
    assert back.flags.c_contiguous and np.array_equal(back, tensor.float().numpy())
    assert not np.shares_memory(back, want)
    want.setflags(write=False)  # a read-only checkpoint array reads the same
    assert np.array_equal(flax_params._from_flax_array(want, kind, *meta), back)
