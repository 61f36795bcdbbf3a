"""The port's LayerNorm-GRU (sheeprl_tpu_torch/ops/ln_gru.py and the cell in
models/blocks.py) against the JAX package's: the plain version against
``_gru_reference`` and the Pallas kernel in interpret mode, the cell against
the flax cell on converted params, and the ``gru_*`` golden.  On the CPU the
wrapper runs its plain version; the CUDA kernel itself is held against that
plain version on the card by chip_smoke.py.  What surrounds the kernel is
checked here: its launch plan for every preset that uses the cell, and a
numpy emulation of its partitioned algorithm (per-CTA slices of hidden
units, per-CTA row statistics merged with Chan's formula)."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.models.blocks import LayerNormGRUCell as FlaxLayerNormGRUCell
from sheeprl_tpu.ops.pallas_gru import _gru_reference, fused_layernorm_gru as pallas_fused
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
from sheeprl_tpu_torch.ops.ln_gru import (
    SERVING_ROWS,
    _bulk_copy_ready,
    _launch_plan,
    _smem_bytes,
    _stage_bytes,
    fused_layernorm_gru,
    ln_gru_reference,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

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


# (H, D) of every preset whose RSSM runs the cell: K = H + D, D the recurrent
# model's dense units (configs/algo/*.yaml of the JAX package)
PRESETS = {
    "dv3_XS": (256, 256),
    "dv3_S": (512, 512),
    "dv3_M": (1024, 640),
    "dv3_L": (2048, 768),
    "dv3_XL": (4096, 1024),  # also dreamer_v3.yaml's default and p2e_dv3
    "dv1": (200, 400),
    "dv2": (600, 400),
    "p2e_dv1": (400, 400),
    "p2e_dv2": (400, 400),
}
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448  # 227 KB, the most one block may opt in to


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8, 37, 128, 1024])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_launch_plan_covers_units_and_rows_within_the_card(preset, batch, itemsize):
    hidden, in_dim = PRESETS[preset]
    k = hidden + in_dim
    plan = _launch_plan(batch, k, hidden, itemsize, H100_SMS, H100_SMEM_PER_BLOCK)
    # every hidden unit owned by exactly one CTA, every CTA co-resident (at
    # most one per SM: its shared memory never lets two share one)
    owned = [u for c in range(plan.ctas) for u in range(*plan.unit_range(c, hidden))]
    assert owned == list(range(hidden))
    assert plan.ctas <= H100_SMS and plan.units & (plan.units - 1) == 0
    # every row in exactly one launch; serving widths in one
    rows = [r for r0, n in plan.chunks for r in range(r0, r0 + n)]
    assert rows == list(range(batch)) and max(n for _, n in plan.chunks) == plan.chunk
    assert len(plan.chunks) == 1 or batch > SERVING_ROWS
    # shared memory: within 227 KB and enough for the largest chunk's layout
    stage = _stage_bytes(plan.unit_block, plan.batch_tile, plan.segs)
    assert _smem_bytes(plan.chunk, plan.units, stage, plan.stages) == plan.smem_bytes <= H100_SMEM_PER_BLOCK
    # the kernel's own checks (csrc/ln_gru.cu::plan_ok)
    assert 1 <= plan.stages <= 32 and plan.segs % 2 == 1 and plan.segs <= 255
    assert plan.unit_block == min(plan.units, 32) and 0 < plan.batch_tile <= 128
    assert plan.batch_tile >= min(batch, 128)
    if itemsize == 4:
        tiles = plan.unit_block // plan.unit_tile * plan.groups
        assert plan.groups * plan.vec == plan.batch_tile and plan.unit_block % plan.unit_tile == 0
        assert tiles * plan.klanes * plan.kgroups == 256 and plan.klanes <= 32
        assert plan.kgroups == 1 or plan.kgroups * tiles * 3 * plan.unit_tile * plan.vec * 4 <= stage
    else:
        tasks = -(-3 * plan.unit_block // 16) * -(-plan.batch_tile // 8 // plan.vec)
        assert plan.batch_tile % 8 == 0 and plan.kgroups <= 4 and tasks * plan.kgroups <= 8


def _emulate(joint, w, b, g, beta, h, eps, plan):
    """The kernel's algorithm in numpy, fp32: each CTA of ``plan`` projects
    the rows u, H+u, 2H+u of its units, takes per-row (mean_c, M2_c) over
    its 3*U_c columns; the partials merge with Chan's formula (mean = sum
    n_c mean_c / N, M2 = sum M2_c + sum n_c (mean_c - mean)^2); each CTA then
    applies the LayerNorm affine and the gates to its own units."""
    hidden = h.shape[1]
    out = np.empty_like(h)
    for r0, rows in plan.chunks:
        x = joint[r0 : r0 + rows]
        slices = []
        for c in range(plan.ctas):
            u0, u1 = plan.unit_range(c, hidden)
            idx = np.concatenate([np.arange(u0, u1) + gate * hidden for gate in range(3)])
            a = (x @ w[idx].T).astype(np.float32)
            if b is not None:
                a = a + b[idx]
            mean_c = a.mean(axis=1)
            slices.append((idx, a, idx.size, mean_c, ((a - mean_c[:, None]) ** 2).sum(axis=1)))
        n_total = 3 * hidden
        mean = sum(n_c * mean_c for _, _, n_c, mean_c, _ in slices) / n_total
        m2 = sum(m2_c + n_c * (mean_c - mean) ** 2 for _, _, n_c, mean_c, m2_c in slices)
        rstd = 1.0 / np.sqrt(m2 / n_total + eps)
        for idx, a, n_c, _, _ in slices:
            units = n_c // 3
            n = (a - mean[:, None]) * rstd[:, None] * g[idx] + beta[idx]
            reset = 1.0 / (1.0 + np.exp(-n[:, :units]))
            cand = np.tanh(reset * n[:, units : 2 * units])
            update = 1.0 / (1.0 + np.exp(-(n[:, 2 * units :] - 1.0)))
            cols = idx[:units]
            out[r0 : r0 + rows, cols] = update * cand + (1.0 - update) * h[r0 : r0 + rows, cols]
    return out


@pytest.mark.parametrize(
    "hidden, in_dim, batch, sm_count, smem, use_bias, ragged",
    [
        (200, 100, 37, 16, H100_SMEM_PER_BLOCK, True, True),  # 13 CTAs of 16 units, the last of 8
        (200, 100, 37, 132, H100_SMEM_PER_BLOCK, False, False),  # DV1's H on the H100: 100 CTAs of 2
        (128, 96, 300, 8, 60000, True, False),  # a small card's shared memory: row chunks of 43
        (512, 64, 8, 132, H100_SMEM_PER_BLOCK, False, False),  # DV3-S's H, 128 CTAs of 4
    ],
)
def test_partitioned_algorithm_matches_jax_reference(hidden, in_dim, batch, sm_count, smem, use_bias, ragged):
    w, b, g, beta, h, x = _inputs(batch, hidden, in_dim, seed=3)
    joint = np.concatenate([h, x], axis=-1)
    plan = _launch_plan(batch, hidden + in_dim, hidden, 4, sm_count, smem)
    assert (hidden % plan.units != 0) == ragged
    got = _emulate(joint, np.ascontiguousarray(w.T), b if use_bias else None, g, beta, h, 1e-3, plan)
    b_jax = b if use_bias else np.zeros_like(b)
    args = [jnp.asarray(a) for a in (joint, w, b_jax, g, beta, h)]
    np.testing.assert_allclose(got, np.asarray(_gru_reference(*args, 1e-3)), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas_fused(*args, 1e-3, True)), **TOL)


@pytest.mark.parametrize(
    "dtype, k, aligned", [(torch.float32, 1024, True), (torch.bfloat16, 1664, True), (torch.float32, 600, False),
                          (torch.bfloat16, 1000, False)]
)
def test_rows_are_padded_for_the_tma_only_when_needed(dtype, k, aligned):
    t = torch.arange(3 * k, dtype=torch.float32).reshape(3, k).to(dtype)
    ready = _bulk_copy_ready(t)
    assert (ready is t) == aligned
    assert ready.shape[1] * ready.element_size() % 128 == 0 and ready.data_ptr() % 16 == 0
    torch.testing.assert_close(ready[:, :k], t, atol=0, rtol=0)
    assert not ready[:, k:].any()
