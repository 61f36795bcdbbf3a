"""The port's LayerNorm-GRU (sheeprl_tpu_torch/ops/ln_gru.py and the cell in
models/blocks.py) against the JAX package's: the plain version against
``_gru_reference`` and the Pallas kernel in interpret mode, the cell against
the flax cell on converted params, and the ``gru_*`` golden.  On the CPU the
wrapper runs its plain version; the CUDA kernel itself is held against that
plain version on the card by chip_smoke.py."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.models.blocks import LayerNormGRUCell as FlaxLayerNormGRUCell
from sheeprl_tpu.ops.pallas_gru import _gru_reference, fused_layernorm_gru as pallas_fused
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference

GOLDEN = Path(__file__).parent / "golden" / "dv3_goldens.npz"
# fp32 on both sides; the projections sum K <= 224 products in different
# orders and the flax LayerNorm uses E[x^2] - E[x]^2 where the port centers
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(batch: int, hidden: int = 128, in_dim: int = 96, seed: int = 0):
    rng = np.random.default_rng(seed)
    k = hidden + in_dim
    w = (rng.normal(size=(k, 3 * hidden)) * 0.2).astype(np.float32)  # flax [K, 3H]
    b = (rng.normal(size=(3 * hidden,)) * 0.1).astype(np.float32)
    g = (1.0 + rng.normal(size=(3 * hidden,)) * 0.1).astype(np.float32)
    beta = (rng.normal(size=(3 * hidden,)) * 0.1).astype(np.float32)
    h = rng.normal(size=(batch, hidden)).astype(np.float32)
    x = rng.normal(size=(batch, in_dim)).astype(np.float32)
    return w, b, g, beta, h, x


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("batch", [5, 37])
def test_reference_matches_jax_reference_and_pallas_interpret(use_bias, batch):
    w, b, g, beta, h, x = _inputs(batch)
    if not use_bias:
        b = np.zeros_like(b)
    joint = np.concatenate([h, x], axis=-1)
    want_ref = np.asarray(_gru_reference(*(jnp.asarray(a) for a in (joint, w, b, g, beta, h)), 1e-3))
    want_pallas = np.asarray(pallas_fused(*(jnp.asarray(a) for a in (joint, w, b, g, beta, h)), 1e-3, True))
    got = ln_gru_reference(_t(joint), _t(w.T), _t(b) if use_bias else None, _t(g), _t(beta), _t(h), 1e-3)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("use_bias", [True, False])
def test_cell_matches_flax_cell(layer_norm, use_bias):
    hidden, in_dim = 128, 96
    w, b, g, beta, h, x = _inputs(7, hidden, in_dim, seed=1)
    dense = {"kernel": jnp.asarray(w)}
    if use_bias:
        dense["bias"] = jnp.asarray(b)
    params = {"Dense_0": dense}
    if layer_norm:
        params["LayerNorm_0"] = {"scale": jnp.asarray(g), "bias": jnp.asarray(beta)}
    flax_cell = FlaxLayerNormGRUCell(hidden_size=hidden, use_bias=use_bias, layer_norm=layer_norm, norm_eps=1e-3)
    want = np.asarray(flax_cell.apply({"params": params}, jnp.asarray(h), jnp.asarray(x)))

    cell = LayerNormGRUCell(in_dim, hidden, use_bias=use_bias, layer_norm=layer_norm, norm_eps=1e-3)
    with torch.no_grad():
        cell.linear.weight.copy_(_t(w.T))
        if use_bias:
            cell.linear.bias.copy_(_t(b))
        if layer_norm:
            cell.norm.weight.copy_(_t(g))
            cell.norm.bias.copy_(_t(beta))
        got = cell(_t(h), _t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cell_matches_gru_golden():
    """The upstream-sheeprl golden (``gru_linear_w`` is already ``[3H, in]``)."""
    gold = np.load(GOLDEN)
    hidden, in_dim = gold["gru_h"].shape[-1], gold["gru_x"].shape[-1]
    cell = LayerNormGRUCell(in_dim, hidden, use_bias=True, layer_norm=True, norm_eps=1e-3)
    with torch.no_grad():
        cell.linear.weight.copy_(_t(gold["gru_linear_w"]))
        cell.linear.bias.copy_(_t(gold["gru_linear_b"]))
        cell.norm.weight.copy_(_t(gold["gru_ln_scale"]))
        cell.norm.bias.copy_(_t(gold["gru_ln_bias"]))
        got = cell(_t(gold["gru_h"]), _t(gold["gru_x"])).numpy()
    np.testing.assert_allclose(got, gold["gru_out"], atol=1e-5, rtol=1e-5)


def _args(batch=4, hidden=8, k=12, dtype=torch.float32):
    return [
        torch.zeros(batch, k, dtype=dtype),
        torch.zeros(3 * hidden, k, dtype=dtype),
        None,
        torch.ones(3 * hidden, dtype=dtype),
        torch.zeros(3 * hidden, dtype=dtype),
        torch.zeros(batch, hidden, dtype=dtype),
    ]


def _bad(case: str):
    args = _args()
    if case == "w_flax_layout":
        args[1] = torch.zeros(12, 24)
    elif case == "h_rows":
        args[5] = torch.zeros(3, 8)
    elif case == "joint_3d":
        args[0] = torch.zeros(1, 4, 12)
    elif case == "bias_shape":
        args[2] = torch.zeros(8)
    elif case == "mixed_dtype":
        args[1] = args[1].to(torch.bfloat16)
    elif case == "float16":
        args = _args(dtype=torch.float16)
    elif case == "non_contiguous":
        args[1] = torch.zeros(12, 24).t()
    elif case == "empty_batch":
        args = _args(batch=0)
    return args


@pytest.mark.parametrize(
    "case, error",
    [
        ("w_flax_layout", ValueError),
        ("h_rows", ValueError),
        ("joint_3d", ValueError),
        ("bias_shape", ValueError),
        ("mixed_dtype", TypeError),
        ("float16", TypeError),
        ("non_contiguous", ValueError),
        ("empty_batch", ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(case, error):
    with pytest.raises(error):
        fused_layernorm_gru(*_bad(case))


def test_cpu_tensors_take_the_plain_version_and_never_count_a_launch():
    before = fused_layernorm_gru.launches
    w, b, g, beta, h, x = _inputs(3)
    joint = _t(np.concatenate([h, x], axis=-1))
    for dtype in (torch.float32, torch.bfloat16):
        args = [a.to(dtype) for a in (joint, _t(w.T), _t(b), _t(g), _t(beta), _t(h))]
        got = fused_layernorm_gru(*args, 1e-3)
        assert got.dtype == dtype
        torch.testing.assert_close(got, ln_gru_reference(*args, 1e-3), atol=0, rtol=0)
    assert fused_layernorm_gru.launches == before
