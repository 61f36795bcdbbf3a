"""``fabric.precision=64-true`` as the JAX package trains it: the package
lists ``64-true`` as float64 (``sheeprl_tpu/parallel/precision.py``) and
never enables ``jax_enable_x64``, so its float64 casts truncate to float32
with JAX's warning and its runs train in float32.  The port resolves
``64-true`` to float32 with a warning of its own and journals the dtypes.

- One PPO update (two epochs of two minibatches, the JAX keys'
  permutations) at ``64-true`` from converted params against the JAX
  ``make_train_step`` at ``64-true``, within PPO's parity tolerances
  (``tests/test_torch_ppo.py``: losses 1e-5, parameters 1e-5, Adam's
  moments 1e-4 of each tree's scale).
- A tiny PPO run at ``64-true`` against the same run at ``32-true``:
  bitwise the same metric rows and checkpoints; its journal's
  ``run_start`` names float32.
"""

from __future__ import annotations

import copy
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_ppo as tp
from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

X64 = ["fabric.precision=64-true"]


def test_a_ppo_update_at_64_true_matches_the_jax_step_at_64_true():
    s = tp._Setup("discrete", extra=X64)
    assert s.jax_cfg.fabric.precision == s.cfg.fabric.precision == "64-true"
    n, mb, total_updates = 8, 2, 10
    opt = tp._jax_optimizer(s.jax_cfg, total_updates)
    jax_step = jax_make_train_step(s.jax_agent, opt, copy.deepcopy(s.jax_cfg), tp._Mesh(), mb, 4)
    params, opt_state = jax.tree_util.tree_map(jnp.asarray, s.params), opt.init(s.params)
    agent, optimizer, step = tp._port_update(s, s.params, None, total_updates, mb)
    assert all(p.dtype == torch.float32 for p in agent.parameters())
    data = tp._data(n, s, 10)
    key = jax.random.PRNGKey(20)
    coefs = (0.2, 0.01, 0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's float64 truncation warning
        out = jax_step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, data), key,
                       tuple(jnp.float32(c) for c in coefs))
    assert all(np.asarray(leaf).dtype == np.float32 for leaf in jax.tree_util.tree_leaves(out[0]))
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, n))) for k in jax.random.split(key, 2)]
    torch_data = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                      else torch.from_numpy(v)) for k, v in data.items()}
    metrics = step(torch_data, perms, coefs)
    tp._check_update(s, jax.tree_util.tree_map(np.asarray, out), agent, optimizer, metrics, step.health_names)


def test_a_ppo_run_at_64_true_is_the_32_true_run_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outs = {}
    for precision in ("32-true", "64-true"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs[precision] = cli.run(tp.RUN + [f"fabric.precision={precision}", f"root_dir={precision}"])
        x64 = [w for w in caught if "requests float64; the run trains in float32" in str(w.message)]
        assert len(x64) == (precision == "64-true")
        (journal,) = Path(outs[precision]["log_dir"]).glob("journal.jsonl")
        start = json.loads(journal.read_text().splitlines()[0])
        assert start["event"] == "run_start" and start["precision"] == precision
        assert start["param_dtype"] == start["compute_dtype"] == "float32"
    a, b = outs["32-true"], outs["64-true"]
    assert np.array_equal(a["metric_rows"], b["metric_rows"]) and len(a["checkpoints"]) == len(b["checkpoints"]) == 2
    for x, y in zip(a["checkpoints"], b["checkpoints"]):
        sx, sy = load_state(x), load_state(y)
        for path, value in tp._leaves(sx["agent"]).items():
            got = tp._leaves(sy["agent"])[path]
            assert got.dtype == value.dtype == np.float32 and np.array_equal(got, value), path
