"""Faults of the port against the JAX package, closed and held to it on the
CPU: the recompile watchdog's shape-change drill
(``diagnostics.telemetry.watchdog.inject_shape_change_iter``), which both
packages' PPO loops journal alike; the config composer's external search
path (``compose``/``compose_group``'s ``extra_dirs`` and
``check_missing``, ``SHEEPRL_TPU_SEARCH_PATH``), through the JAX test's
external ``exp`` overlay; and DreamerV3's own Gumbel draws, which were NaN
(every sampled categorical then took its first class)."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import ConfigError as JaxConfigError
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import compose_group as jax_compose_group
from sheeprl_tpu_torch.config import ConfigError, compose, compose_group, own_targets
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

DRILL = ["diagnostics.telemetry.watchdog.inject_shape_change_iter=2", "algo.run_test=False"]


def _drill_lines(journal_path: str):
    from sheeprl_tpu.diagnostics.journal import read_journal

    events = read_journal(journal_path)
    faults = [{k: v for k, v in e.items() if k != "t"} for e in events if e["event"] == "fault_injection"]
    recompiles = []
    for e in (e for e in events if e["event"] == "recompile"):
        # a leaf's path below the batch argument and its shape change, in
        # either package's spelling
        leaves = sorted(
            (re.search(r"(\['[^]]+'\](?:\['[^]]+'\])?)", line).group(1),
             tuple(re.findall(r"\[(\d+(?:, \d+)*)\]", line))[-2:])  # the shapes, not the argument's index
            for line in e["diff"])
        recompiles.append((e["fn"], e["count"], leaves))
    return faults, recompiles


def test_the_shape_change_drill_journals_as_the_jax_ppo_loop_does(tmp_path, monkeypatch):
    """PPO with the drill at iteration 2 in both packages: one
    ``fault_injection`` (``kind=shape_change``, ``pad=1``) and one
    ``recompile`` of ``train_step`` whose diff grows every leaf of the
    batch by the one padded row, the same in both journals; the padded row
    is never sampled, so the run trains on."""
    from pathlib import Path

    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch import cli
    from test_torch_ppo import RUN

    monkeypatch.chdir(tmp_path)
    out = cli.run(RUN + DRILL + ["root_dir=port"])
    assert np.isfinite(out["metric_rows"]).all()
    jax_run(RUN + DRILL + ["root_dir=jax"])
    lines = {root: _drill_lines(str(next(Path(tmp_path).glob(f"logs/runs/{root}/**/journal.jsonl"))))
             for root in ("port", "jax")}
    assert lines["port"] == lines["jax"]
    faults, recompiles = lines["port"]
    assert faults == [{"event": "fault_injection", "iter_num": 2, "kind": "shape_change", "pad": 1}]
    assert len(recompiles) == 1 and recompiles[0][:2] == ("train_step", 1)
    assert {shapes[0].split(",")[0] + "->" + shapes[1].split(",")[0] for _, shapes in recompiles[0][2]} == {"8->9"}


def test_the_drill_is_off_by_default_and_only_in_the_ppo_loop(tmp_path):
    """Without the key nothing is padded; the on-policy loops the JAX
    package does not drill (A2C) read the key and leave the batch alone."""
    from sheeprl_tpu_torch.diagnostics import Diagnostics

    batch = {"obs": {"state": torch.zeros(4, 3)}, "actions": torch.zeros(4, 1)}
    off = Diagnostics(compose(["exp=ppo", "env=dummy"]))
    assert off.maybe_inject_shape_change(2, batch) is batch
    on = Diagnostics(compose(["exp=ppo", "env=dummy", DRILL[0]]))
    assert on.maybe_inject_shape_change(1, batch) is batch
    padded = on.maybe_inject_shape_change(2, batch, pad=2)
    assert padded["obs"]["state"].shape == (6, 3) and padded["actions"].shape == (6, 1)
    torch.testing.assert_close(padded["actions"][4:], batch["actions"][-1:].expand(2, 1))

    import inspect

    from sheeprl_tpu_torch.algos.a2c import a2c
    from sheeprl_tpu_torch.algos.ppo import ppo

    assert "shape_drill=True" in inspect.getsource(ppo.main)
    assert "shape_drill" not in inspect.getsource(a2c.main)


# ---------------------------------------------------------------------------
# the config search path
# ---------------------------------------------------------------------------

SMOKE = ("# @package _global_\ndefaults:\n  - override /env: dummy\n  - _self_\nalgo:\n  name: smoke\n"
         "  total_steps: 8\n  per_rank_batch_size: 2\nbuffer:\n  size: 16\n")


@pytest.fixture
def external(tmp_path):
    """The JAX test's external ``exp`` overlay, an external ``optim`` option
    naming the JAX package's optimizer, and one with a value left ``???``."""
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "smoke.yaml").write_text(SMOKE)
    (tmp_path / "exp" / "bad.yaml").write_text("# @package _global_\nalgo:\n  name: bad\n")
    (tmp_path / "optim").mkdir()
    (tmp_path / "optim" / "mine.yaml").write_text("_target_: optax.sgd\nlearning_rate: 0.5\nmomentum: 0.8\n")
    return tmp_path


def _same_tree(port, jax_tree, path=""):
    port, jax_tree = dict(port), dict(own_targets(jax_tree))
    assert sorted(port) == sorted(jax_tree), path
    for k in port:
        if isinstance(port[k], dict):
            _same_tree(port[k], jax_tree[k], f"{path}.{k}")
        elif k not in ("now",) and not str(port[k]).startswith(("logs/", "20")):
            assert port[k] == jax_tree[k], f"{path}.{k}: {port[k]!r} != {jax_tree[k]!r}"


@pytest.mark.parametrize("how", ["extra_dirs", "env"])
def test_an_external_exp_composes_to_the_jax_tree(external, monkeypatch, how):
    overrides = ["exp=smoke", "seed=7", "env.num_envs=2", "run_name=smoke"]
    if how == "env":
        monkeypatch.setenv("SHEEPRL_TPU_SEARCH_PATH", f"/nonexistent:{external}")
        port, jax_tree = compose(overrides), jax_compose(overrides)
    else:
        port = compose(overrides, extra_dirs=[str(external)])
        jax_tree = jax_compose(overrides, extra_dirs=[str(external)])
    assert port.algo.name == "smoke" and port.seed == 7 and port.env.num_envs == 2
    assert port.env.id == "discrete_dummy" and port.buffer.size == 16 and port.env.action_repeat == 1
    assert port.exp_name == "smoke_discrete_dummy" and port.root_dir == "smoke/discrete_dummy"
    _same_tree(port, jax_tree)


def test_external_options_shadow_shipped_ones_and_their_targets_are_the_ports(external):
    """An external group option is found first; a ``_target_`` it names in
    the JAX package (``optax.sgd`` here) builds the port's counterpart."""
    from sheeprl_tpu_torch.config import instantiate

    cfg = compose_group("optim", "mine", extra_dirs=[str(external)])
    assert dict(cfg) == dict(own_targets(jax_compose_group("optim", "mine", extra_dirs=[str(external)])))
    optimizer = instantiate(cfg)([torch.nn.Parameter(torch.zeros(2))])
    assert type(optimizer).__name__ == "SGD" and optimizer.param_groups[0]["momentum"] == 0.8
    with pytest.raises(ConfigError, match="not found"):
        compose_group("optim", "mine")


def test_check_missing(external):
    """A value left ``???`` raises in both packages, unless
    ``check_missing=False``, which returns the tree as composed."""
    with pytest.raises(ConfigError, match="Mandatory"):
        compose(["exp=bad"], extra_dirs=[str(external)])
    with pytest.raises(JaxConfigError, match="Mandatory"):
        jax_compose(["exp=bad"], extra_dirs=[str(external)])
    port = compose(["exp=bad"], extra_dirs=[str(external)], check_missing=False)
    jax_tree = jax_compose(["exp=bad"], extra_dirs=[str(external)], check_missing=False)
    assert port.algo.name == "bad" and port.env.id == "???"
    _same_tree(port, jax_tree)


# ---------------------------------------------------------------------------
# DreamerV3's Gumbel draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gumbel_draws_are_finite_standard_gumbel(dtype):
    """``gumbel_like`` draws what ``jax.random.gumbel`` draws in law: finite,
    mean Euler's constant, variance pi^2 / 6.  (It returned NaN everywhere,
    so every sampled stochastic state and action took its first class.)"""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import compute_stochastic_state, gumbel_like

    g = gumbel_like(torch.empty(400_000, dtype=dtype), torch.Generator().manual_seed(0)).float()
    assert torch.isfinite(g).all()
    tol = 0.02 if dtype == torch.float32 else 0.05  # bfloat16's uniform draw has 8 bits
    assert abs(g.mean().item() - 0.5772) < tol and abs(g.var().item() - np.pi ** 2 / 6) < 2.5 * tol
    # a sampled categorical state over equal logits takes every class
    logits = torch.zeros(2000, 4, 8, dtype=dtype)
    state = compute_stochastic_state(logits, 8, torch.Generator().manual_seed(1))
    taken = state.reshape(-1, 8).argmax(-1)
    assert set(taken.tolist()) == set(range(8))
