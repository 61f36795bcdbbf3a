"""The port's train-health statistics against the JAX package's
``health_stats`` on the same trees, on the CPU at a test width: gradients,
updates and parameters of a DreamerV3 agent, some units zeroed on purpose,
converted into the flax layout by the weight converter's rules.  Norms
agree to 1e-5 relative and ``dead_frac`` exactly, with and without the
per-module detail: the port counts a unit on the torch axis that holds the
flax leaf's last axis (``Linear`` and Conv dim 0, ConvTranspose dim 1)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sheeprl_tpu.diagnostics.health import health_stats as jax_health_stats
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import TRAINED, health_unit_dims
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.diagnostics.health import explained_variance, health_names, health_stats, mean_stats
from sheeprl_tpu_torch.interop.flax_params import _to_flax, param_spec
from test_torch_dv3_train import OBS_SPACE, TINY
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


@pytest.fixture(scope="module")
def agent():
    cfg = compose(TINY + ["env.id=multidiscrete_dummy"])
    return build_agent((2, 2), False, cfg, OBS_SPACE, None, "cpu")


def _flax(spec, values):
    """The flax trees of per-parameter values (``id(param) -> tensor``)."""
    out = {}
    for key, sub in spec.items():
        if isinstance(sub, dict):
            out[key] = _flax(sub, values)
        else:
            tensor, kind = sub
            out[key] = np.ascontiguousarray(_to_flax(values[id(tensor)], kind).numpy())
    return out


@pytest.mark.parametrize("per_module", [False, True])
def test_health_stats_match_jax_on_converted_trees(agent, per_module):
    params = {name: list(getattr(agent, name).parameters()) for name in TRAINED}
    dims = health_unit_dims(agent, params)
    rng = np.random.default_rng(3)

    def draw(p, scale):
        return torch.from_numpy((scale * rng.normal(size=p.shape)).astype(np.float32))

    grads = {n: [draw(p, 1.0) for p in ps] for n, ps in params.items()}
    updates = {n: [draw(p, 1e-3) for p in ps] for n, ps in params.items()}
    # units zeroed on purpose: the first unit of every third tensor, whole
    # tensors of every seventh, a gradient under dead_eps
    zeroed = 0
    for name in TRAINED:
        for i, (g, d) in enumerate(zip(grads[name], dims[name])):
            if i % 7 == 0:
                g.zero_()
                zeroed += 1
            elif i % 3 == 0:
                g.select(d, 0).fill_(1e-9 if g.dim() > 1 else 0.0)
                zeroed += 1
    assert zeroed > 10
    got = health_stats(grads, updates, params, unit_dims=dims, per_module=per_module, dead_eps=1e-8)
    spec = param_spec(*agent)

    def trees(values):
        by_id = {id(p): v for n in TRAINED for p, v in zip(params[n], values[n])}
        return {n: _flax(spec[n], by_id) for n in TRAINED}

    want = jax_health_stats(trees(grads), trees(updates), trees({n: [p.detach() for p in ps] for n, ps in params.items()}),
                            per_module=per_module, dead_eps=1e-8)
    assert list(got) == list(want) == health_names(TRAINED, per_module)
    for key, value in want.items():
        if key.endswith("dead_frac"):
            assert float(got[key]) == float(value), key
            assert 0.0 < float(value) < 1.0
        else:
            np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-5, err_msg=key)


def test_unit_axes_follow_the_converters_layout(agent):
    params = {name: list(getattr(agent, name).parameters()) for name in TRAINED}
    dims = health_unit_dims(agent, params)
    kinds = {}

    def walk(spec):
        for sub in spec.values():
            if isinstance(sub, dict):
                walk(sub)
            else:
                kinds[id(sub[0])] = sub[1]

    walk(param_spec(*agent))
    seen = set()
    for name in TRAINED:
        for p, d in zip(params[name], dims[name]):
            kind = kinds[id(p)]  # every trained parameter has a flax leaf
            seen.add(kind)
            assert d == {"dense": 0, "conv": 0, "conv_transpose": 1}.get(kind, p.dim() - 1)
    assert {"dense", "conv", "conv_transpose"} <= seen


def test_explained_variance_and_mean_stats():
    rng = np.random.default_rng(0)
    returns = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    values = returns + 0.1 * torch.from_numpy(rng.normal(size=64).astype(np.float32))
    ev = float(explained_variance(values, returns))
    want = 1 - np.var((returns - values).numpy()) / np.var(returns.numpy())
    assert ev == pytest.approx(want, rel=1e-5)
    assert float(explained_variance(values, torch.zeros(64))) == 0.0
    assert mean_stats([{"a": 1.0, "b": 2.0}, None, {"a": 3.0}]) == {"a": 2.0, "b": 2.0}
