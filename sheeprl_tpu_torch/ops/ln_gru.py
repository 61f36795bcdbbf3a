"""Fused LayerNorm-GRU cell: the hand-written CUDA kernel's wrapper, its
launch plan and its plain PyTorch version.

Replaces the TPU kernel ``sheeprl_tpu/ops/pallas_gru.py::_gru_kernel``
(launched by ``_gru_pallas`` through ``pl.pallas_call``), the RSSM's
recurrent step: ``new_h = GRU(LayerNorm(joint @ w^T + b; g, beta), h)``,
run once per serving dispatch and per player step, and 64 + 15 times per
DreamerV3 gradient step (the dynamic scan at B=16, imagination at
T*B=1024).  The kernel is ``csrc/ln_gru.cu``.  Under autograd it is the
forward of :class:`_FusedLayerNormGRU`, whose backward recomputes through
:func:`ln_gru_reference`: the JAX package's ``custom_vjp`` has no backward
kernel either.

Bound on an H100.  The kernel must read the weight ``w`` (3H·K elements) and
the joint input (B·K), and it does 2·B·K·3H operations.  At DV3-S (K=1024,
3H=1536) in fp32, ``w`` is 6.3 MB, 1.9 us at 3.35 TB/s, and the operations at
B=128 are 0.40 GFLOP, 6.0 us at the 67 TFLOP/s fp32 rate: the serving widths
are bound by the bytes of ``w`` up to B ~ 37 and by fp32 operations near
B=128.  In bf16 they stay bound by bytes.

The design: one cooperative launch per row chunk.  Each CTA owns whole
hidden units (the three rows of ``w`` that feed each: reset ``u``, candidate
``H+u``, update ``2H+u``), so the grid fills the card at every B and each
byte of ``w`` is read once.  A producer warp streams ``w`` and ``joint``
through a ring of shared-memory stages with bulk copies on mbarriers; fp32
products run on the CUDA cores (TF32 would keep about three decimal digits,
too few for the 1e-4 fp32 tolerance ``serve`` is held to, and ``wgmma`` takes
no fp32), bf16 products on the tensor cores (``mma.sync``).  The fp32
projection stays in shared memory; each CTA publishes per row its local
(mean, centered sum of squares), the grid syncs once, and every CTA merges
the partials with Chan's formula (``mean = sum n_c mean_c / N``,
``M2 = sum M2_c + sum n_c (mean_c - mean)^2``) before its gates.  Rows
beyond what one CTA's shared memory holds go to further launches
(:func:`_launch_plan`: above 2,000 rows at S, about 250 at XL); serving
widths (B <= 128) are one launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's fixed shape (csrc/ln_gru.cu): 8 consumer warps and a
# producer; K moves in 128-byte segments, each box of a stage starts on a
# 1024-byte boundary
_CONSUMERS = 256
_CONSUMER_WARPS = 8
_SEG_BYTES = 128
_BOX_ALIGN = 1024
_MAX_STAGES = 32
_MAX_SEGS = 255
_BARRIER_BYTES = 2 * _MAX_STAGES * 8
_MAX_BATCH_TILE = 128
_MAX_UNIT_BLOCK = 32
#: batch widths the plan always serves in one launch
SERVING_ROWS = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pow2floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


@dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut for the kernel (see csrc/ln_gru.cu)."""

    units: int  # U: hidden units each CTA owns (a power of two)
    ctas: int  # ceil(H / U), at most one per SM
    unit_block: int  # units per pass, min(U, 32)
    batch_tile: int  # batch rows per pass
    vec: int  # fp32: batch columns per thread (TC); bf16: 8-column MMA tiles per warp
    groups: int  # fp32: column groups (batch_tile = vec * groups); bf16: vec
    kgroups: int  # consumer groups splitting each stage's K (fp32: groups of warps)
    klanes: int  # fp32: lanes of a warp splitting K (KL); bf16: 1
    unit_tile: int  # fp32: units per thread (TR); bf16: 1
    segs: int  # 128-byte segments of K per stage (odd)
    stages: int  # ring depth
    chunk: int  # most batch rows per launch
    smem_bytes: int  # dynamic shared memory of each launch
    chunks: Tuple[Tuple[int, int], ...]  # (first row, rows) of each launch

    def unit_range(self, cta: int, hidden: int) -> Tuple[int, int]:
        return cta * self.units, min(hidden, (cta + 1) * self.units)


def _smem_bytes(rows: int, units: int, stage_bytes: int, stages: int) -> int:
    """csrc/ln_gru.cu::layout_of: barriers | row stats | projection | ring
    (aligned at run time within 1024 bytes of slack)."""
    return (_BARRIER_BYTES + _align16(rows * 8) + _align16(rows * (3 * units + 1) * 4) + _BOX_ALIGN
            + stages * stage_bytes)


def _stage_bytes(unit_block: int, batch_tile: int, segs: int) -> int:
    """Three w boxes (one per gate) and one joint box, each 1024-aligned."""
    def box(rows: int) -> int:
        return _cdiv(rows * segs * _SEG_BYTES, _BOX_ALIGN) * _BOX_ALIGN

    return 3 * box(unit_block) + box(batch_tile)


def _launch_plan(B: int, K: int, H: int, itemsize: int, sm_count: int, smem_per_block: int) -> LaunchPlan:
    """Cut a ``[B, K] x [3H, K]`` cell for the kernel: units per CTA, the
    per-pass tiles, the K segments per stage, the ring depth, the row chunks
    and the shared memory of each launch.  Pure: the CPU tests reach it.
    Raises ``ValueError`` for a shape the card cannot hold."""
    if min(B, K, H, sm_count) <= 0 or itemsize not in (2, 4):
        raise ValueError(f"no plan for B={B} K={K} H={H} itemsize={itemsize} sm_count={sm_count}")
    units = _pow2ceil(_cdiv(H, sm_count))
    ctas = _cdiv(H, units)
    unit_block = min(units, _MAX_UNIT_BLOCK)
    tile_rows = min(B, _MAX_BATCH_TILE)
    if itemsize == 4:
        # register tiles of TR=2 units (6 gate rows) by TC <= 8 columns (a
        # 4-unit tile spills: 288 threads get at most 168 registers each);
        # the 256 consumer threads split K over KL lanes and KG warp groups
        unit_tile = 2 if unit_block >= 2 else 1
        vec = min(8, _pow2ceil(tile_rows))
        groups = _pow2ceil(_cdiv(tile_rows, vec))
        batch_tile = vec * groups
        tiles = unit_block // unit_tile * groups
        klanes = min(32, _CONSUMERS // tiles)
        kgroups = _CONSUMERS // (tiles * klanes)
    else:
        unit_tile = klanes = 1
        m_tiles = _cdiv(3 * unit_block, 16)
        n_tiles = _cdiv(tile_rows, 8)
        vec = 1
        while m_tiles * _cdiv(n_tiles, vec) > _CONSUMER_WARPS:
            vec *= 2
        groups = vec
        batch_tile = 8 * n_tiles
        kgroups = min(4, _pow2floor(_CONSUMER_WARPS // (m_tiles * _cdiv(n_tiles, vec))))

    def max_rows(stages: int) -> int:
        room = smem_per_block - _smem_bytes(0, units, _stage_bytes(unit_block, batch_tile, 1), stages) - 32
        return max(0, room // (8 + 4 * (3 * units + 1)))  # 32: two align16 roundings

    # prefer four stages in flight; go down to two before splitting serving widths
    chunk = max_rows(4)
    if chunk < min(B, SERVING_ROWS):
        chunk = max_rows(2)
    chunk = min(B, chunk)
    if chunk < 1:
        raise ValueError(f"H={H} needs more shared memory per CTA than {smem_per_block} bytes")
    # segments per stage: odd (so eight consecutive rows' same segment take
    # eight swizzle phases), as many as two stages hold, and K in at least
    # two stages so the product of the first overlaps the load of the second
    total_segs = _cdiv(K * itemsize, _SEG_BYTES)
    room = smem_per_block - _smem_bytes(chunk, units, 0, 0)
    segs = min(_cdiv(total_segs, 2) | 1, _MAX_SEGS)
    while segs > 1 and 2 * _stage_bytes(unit_block, batch_tile, segs) > room:
        segs -= 2
    stage_bytes = _stage_bytes(unit_block, batch_tile, segs)
    if itemsize == 4:
        # fp32 k-groups reduce through one stage: 3*TR*TC floats per tile
        while kgroups > 1 and kgroups * tiles * 3 * unit_tile * vec * 4 > stage_bytes:
            kgroups //= 2
    jobs = _cdiv(units, unit_block) * _cdiv(chunk, batch_tile) * _cdiv(total_segs, segs)
    stages = min(_MAX_STAGES, room // stage_bytes, jobs)
    chunks = tuple((r0, min(chunk, B - r0)) for r0 in range(0, B, chunk))
    return LaunchPlan(units, ctas, unit_block, batch_tile, vec, groups, kgroups, klanes, unit_tile, segs, stages, chunk,
                      _smem_bytes(chunk, units, stage_bytes, stages), chunks)


def ln_gru_reference(
    joint: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    g: torch.Tensor,
    beta: torch.Tensor,
    h: torch.Tensor,
    eps: float = 1e-3,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function in fp32
    arithmetic, with ``w`` in the same ``[3H, K]`` layout."""
    a = joint.float() @ w.float().t()
    if b is not None:
        a = a + b.float()
    mean = a.mean(dim=-1, keepdim=True)
    centered = a - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    n = centered * torch.rsqrt(var + eps) * g.float() + beta.float()
    hidden = h.shape[-1]
    reset = torch.sigmoid(n[:, :hidden])
    cand = torch.tanh(reset * n[:, hidden : 2 * hidden])
    update = torch.sigmoid(n[:, 2 * hidden :] - 1.0)
    return (update * cand + (1.0 - update) * h.float()).to(h.dtype)


def _check(joint, w, b, g, beta, h) -> None:
    tensors = {"joint": joint, "w": w, "g": g, "beta": beta, "h": h}
    if b is not None:
        tensors["b"] = b
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != joint.device:
            raise ValueError(f"{name} is on {t.device}, joint on {joint.device}")
        if t.dtype != joint.dtype:
            raise TypeError(f"{name} is {t.dtype}, joint is {joint.dtype}: all inputs share one dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if joint.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {joint.dtype} not supported (float32 or bfloat16)")
    if joint.dim() != 2 or h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"joint, w and h must be 2-D, got {tuple(joint.shape)}, {tuple(w.shape)}, {tuple(h.shape)}")
    batch, joint_dim = joint.shape
    hidden = h.shape[1]
    if batch == 0 or joint_dim == 0 or hidden == 0:
        raise ValueError(f"empty input: joint {tuple(joint.shape)}, h {tuple(h.shape)}")
    if h.shape[0] != batch:
        raise ValueError(f"h has {h.shape[0]} rows, joint {batch}")
    if tuple(w.shape) != (3 * hidden, joint_dim):
        raise ValueError(f"w must be [3H, K] = {(3 * hidden, joint_dim)}, got {tuple(w.shape)}")
    for name in ("g", "beta", "b"):
        if name in tensors and tuple(tensors[name].shape) != (3 * hidden,):
            raise ValueError(f"{name} must be [{3 * hidden}], got {tuple(tensors[name].shape)}")


@torch.library.custom_op("sheeprl_tpu_torch::ln_gru_forward", mutates_args=())
def _ln_gru_forward(joint: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], g: torch.Tensor,
                    beta: torch.Tensor, h: torch.Tensor, eps: float) -> torch.Tensor:
    """The cell's forward as one operator: the kernel on a CUDA tensor,
    :func:`ln_gru_reference` on a CPU tensor.  Being one operator, it is one
    entry for ``FlopCounterMode``, which counts it by
    :func:`_ln_gru_flops` on both devices and never sees the plain version's
    own products."""
    if joint.device.type == "cpu":
        return ln_gru_reference(joint, w, b, g, beta, h, eps)
    from sheeprl_tpu_torch.ops import cuda_build

    return _launch(cuda_build.load("ln_gru"), joint, w, b, g, beta, h, eps)


@register_flop_formula(torch.ops.sheeprl_tpu_torch.ln_gru_forward)
def _ln_gru_flops(joint_shape, w_shape, *args, **kwargs) -> int:
    """The kernel's product, ``2·B·K·3H`` (``FlopCounterMode`` counts
    products only, so the LayerNorm and the gates are not counted)."""
    return 2 * joint_shape[0] * joint_shape[1] * w_shape[0]


class _FusedLayerNormGRU(torch.autograd.Function):
    """The cell under autograd.  Forward: the kernel on a CUDA tensor,
    :func:`ln_gru_reference` on a CPU tensor.  Backward: recompute through
    :func:`ln_gru_reference` on the saved inputs and differentiate that, the
    design of the JAX package's ``_fused_bwd`` (``custom_vjp`` over
    ``_gru_reference``): the TPU kernel has no backward kernel, so neither
    does the port."""

    @staticmethod
    def forward(ctx, joint, w, b, g, beta, h, eps):
        ctx.eps = eps
        ctx.save_for_backward(joint, w, b, g, beta, h)
        return torch.ops.sheeprl_tpu_torch.ln_gru_forward(joint, w, b, g, beta, h, eps)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            out = ln_gru_reference(*inputs, ctx.eps)
            wrt = [i for i, (t, need) in enumerate(zip(inputs, needs)) if need and t is not None]
            grads = torch.autograd.grad(out, [inputs[i] for i in wrt], grad_out) if wrt else ()
        result = [None] * 7
        for i, grad in zip(wrt, grads):
            result[i] = grad
        return tuple(result)


def fused_layernorm_gru(
    joint: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    g: torch.Tensor,
    beta: torch.Tensor,
    h: torch.Tensor,
    eps: float = 1e-3,
) -> torch.Tensor:
    """``new_h = GRU(LayerNorm(joint @ w^T + b; g, beta), h)``.

    ``joint`` is ``[B, K]`` with ``K = H + D`` (``concat(h, x)``), ``w`` is
    ``[3H, K]`` (``nn.Linear.weight`` layout; gate order reset | candidate |
    update), ``b`` is ``[3H]`` or None, ``g``/``beta`` the LayerNorm scale and
    shift ``[3H]``, ``h`` is ``[B, H]``.  All contiguous, one dtype (float32
    or bfloat16), one device.  On a CPU tensor the forward is
    :func:`ln_gru_reference`; on a CUDA tensor it launches the kernel, or
    raises.  Either way the result carries a gradient for every input that
    requires one (:class:`_FusedLayerNormGRU`).
    ``fused_layernorm_gru.launches`` counts kernel launches.
    """
    _check(joint, w, b, g, beta, h)
    if joint.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_layernorm_gru runs on cpu or cuda tensors, got {joint.device}")
    return _FusedLayerNormGRU.apply(joint, w, b, g, beta, h, eps)


def _launch(lib, joint, w, b, g, beta, h, eps) -> torch.Tensor:
    """Run the kernel of library ``lib`` (``cuda_build.load("ln_gru")`` or a
    variant of it) on checked CUDA inputs: one launch per row chunk of the
    plan, each counted in ``fused_layernorm_gru.launches``."""
    batch = joint.shape[0]
    hidden = h.shape[1]
    joint, w = _bulk_copy_ready(joint), _bulk_copy_ready(w)
    k_padded = joint.shape[1]
    sm_count, smem_per_block = _device_limits(lib, joint.device)
    plan = _launch_plan(batch, k_padded, hidden, joint.element_size(), sm_count, smem_per_block)
    out = torch.empty_like(h)
    partials = torch.empty((plan.chunk, plan.ctas, 2), dtype=torch.float32, device=joint.device)
    row_bytes = {"joint": k_padded * joint.element_size(), "h": hidden * h.element_size()}
    with torch.cuda.device(joint.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0, rows in plan.chunks:
            rc = lib.ln_gru_forward(
                _DTYPE_CODES[joint.dtype],
                joint.data_ptr() + r0 * row_bytes["joint"],
                w.data_ptr(),
                None if b is None else b.data_ptr(),
                g.data_ptr(),
                beta.data_ptr(),
                h.data_ptr() + r0 * row_bytes["h"],
                out.data_ptr() + r0 * row_bytes["h"],
                partials.data_ptr(),
                rows,
                k_padded,
                hidden,
                float(eps),
                plan.units,
                plan.ctas,
                plan.unit_block,
                plan.batch_tile,
                plan.vec,
                plan.groups,
                plan.kgroups,
                plan.klanes,
                plan.unit_tile,
                plan.segs,
                plan.stages,
                plan.smem_bytes,
                stream,
            )
            if rc != 0:
                raise RuntimeError(f"ln_gru kernel launch failed: {lib.ln_gru_error_string(rc).decode()}")
            # one dispatcher thread calls this on the serving path, so the
            # increment needs no lock
            fused_layernorm_gru.launches += 1
    return out


fused_layernorm_gru.launches = 0
_LIMITS: Dict[int, Tuple[int, int]] = {}


def _device_limits(lib, device: torch.device) -> Tuple[int, int]:
    """(SM count, shared memory one block may opt in to) of a CUDA device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _LIMITS:
        import ctypes

        sms, smem = ctypes.c_int(), ctypes.c_int()
        rc = lib.ln_gru_device_limits(index, ctypes.byref(sms), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"ln_gru: reading device limits failed: {lib.ln_gru_error_string(rc).decode()}")
        _LIMITS[index] = (sms.value, smem.value)
    return _LIMITS[index]


def _bulk_copy_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the TMA unit can read its rows as 128-byte segments
    (16-byte aligned start, rows a whole number of segments), else a copy
    zero-padded in K.  The DV3 presets need no copy (K = 512 ... 5120 are
    multiples of 64); DV1 (K=600) and DV2 (K=1000) pay one per call."""
    step = _SEG_BYTES // t.element_size()
    pad = -t.shape[1] % step
    if pad == 0 and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, pad))
