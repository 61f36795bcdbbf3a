"""Fused LayerNorm-GRU cell: the hand-written CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``sheeprl_tpu/ops/pallas_gru.py::_gru_kernel``
(launched by ``_gru_pallas`` through ``pl.pallas_call``), the RSSM's
recurrent step: ``new_h = GRU(LayerNorm(joint @ w^T + b; g, beta), h)``,
run once per serving dispatch.  The kernel is ``csrc/ln_gru.cu``.

Bound on an H100.  The kernel must read the weight ``w`` (3H·K elements) and
the joint input (B·K), and it does 2·B·K·3H multiply-adds' worth of
operations.  At DV3-S (K=1024, 3H=1536) in fp32, ``w`` is 6.3 MB, 1.9 us at
3.35 TB/s, and the operations at B=128 are 0.40 GFLOP, 6.0 us at the 67
TFLOP/s fp32 rate; so the serving widths (B = 8…128) are bound by the bytes
of ``w`` at small B and by fp32 operations near B=128.  The design: one
64-row batch tile per block reads ``w`` through shared memory once, so at
B <= 64 every weight is read from device memory once; the [B, 3H] projection
makes one fp32 round trip through a scratch buffer (B·3H·8 bytes, small
beside ``w``) so a second launch can normalize whole rows.  The product runs
on the fp32 cores, not the tensor cores: a wgmma/TMA version that keeps the
row statistics in the GEMM epilogue is queued in ROADMAP.md (Queue 2).
"""

from __future__ import annotations

from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    or bfloat16), one device.  On a CPU tensor this is
    :func:`ln_gru_reference`; on a CUDA tensor it launches the kernel, or
    raises.  ``fused_layernorm_gru.launches`` counts kernel launches.
    """
    _check(joint, w, b, g, beta, h)
    if joint.device.type == "cpu":
        return ln_gru_reference(joint, w, b, g, beta, h, eps)
    if joint.device.type != "cuda":
        raise RuntimeError(f"fused_layernorm_gru runs on cpu or cuda tensors, got {joint.device}")
    from sheeprl_tpu_torch.ops import cuda_build

    lib = cuda_build.load("ln_gru")
    batch, joint_dim = joint.shape
    hidden = h.shape[1]
    out = torch.empty_like(h)
    scratch = torch.empty((batch, 3 * hidden), dtype=torch.float32, device=joint.device)
    with torch.cuda.device(joint.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ln_gru_forward(
            _DTYPE_CODES[joint.dtype],
            joint.data_ptr(),
            w.data_ptr(),
            None if b is None else b.data_ptr(),
            g.data_ptr(),
            beta.data_ptr(),
            h.data_ptr(),
            out.data_ptr(),
            scratch.data_ptr(),
            batch,
            joint_dim,
            hidden,
            float(eps),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"ln_gru kernel launch failed: {lib.ln_gru_error_string(rc).decode()}")
    # one dispatcher thread calls this on the serving path, so the
    # increment needs no lock
    fused_layernorm_gru.launches += 1
    return out


fused_layernorm_gru.launches = 0
