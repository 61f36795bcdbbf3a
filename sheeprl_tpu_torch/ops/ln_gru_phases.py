"""Where the LayerNorm-GRU kernel's time goes, phase by phase, on the card.

Builds the ``ln_gru_phases`` variant of ``csrc/ln_gru.cu`` (the same source
with ``-DLN_GRU_PHASES``: thread 0 of every CTA records ``clock64()`` at seven
points) and prints, per shape, the median over CTAs and launches of each
phase's duration:

    first_stage   entry -> the first stage of w and joint has landed
    products      -> the projection is in shared memory (k-groups reduced)
    local_stats   -> this CTA's (mean_c, M2_c) per row are written
    grid_sync     -> every CTA has passed the grid barrier
    merge         -> each row's mean and rstd are merged from all partials
    gates         -> h' is written

Run on a machine with a CUDA device, from the root of a checkout:

    python -m sheeprl_tpu_torch.ops.ln_gru_phases [--reps 5]

Cycles become microseconds at the SM clock ``nvidia-smi`` reports after the
run.  The stamps cost a few stores per CTA; the kernel's own time is what
``chip_smoke.py`` measures.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from typing import Dict, List

import torch

PHASES = ("first_stage", "products", "local_stats", "grid_sync", "merge", "gates")
# (H, D, B): DreamerV3-S and -XL at the widths chip_smoke.py times
SHAPES = [(512, 512, 1), (512, 512, 8), (512, 512, 37), (512, 512, 128), (4096, 1024, 8), (4096, 1024, 128)]


def _sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def measure(hidden: int, in_dim: int, batch: int, dtype: torch.dtype, reps: int = 5) -> Dict[str, float]:
    """Median cycles of each phase at one shape, over CTAs and ``reps`` launches."""
    from sheeprl_tpu_torch.ops import cuda_build
    from sheeprl_tpu_torch.ops import ln_gru

    lib = cuda_build.load("ln_gru_phases")
    k = hidden + in_dim
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    joint, w = randn(batch, k).to(dtype), (randn(3 * hidden, k) / k**0.5).to(dtype)
    g, beta, h = (1 + 0.1 * randn(3 * hidden)).to(dtype), (0.1 * randn(3 * hidden)).to(dtype), torch.tanh(
        randn(batch, hidden)).to(dtype)
    plan = ln_gru._launch_plan(batch, k, hidden, joint.element_size(), *ln_gru._device_limits(lib, joint.device))
    if len(plan.chunks) != 1:
        raise ValueError(f"B={batch} takes {len(plan.chunks)} launches; phases are read for one")
    stamps = (ctypes.c_ulonglong * (plan.ctas * (len(PHASES) + 1)))()
    per_phase: Dict[str, List[float]] = {name: [] for name in PHASES}
    for i in range(reps + 2):
        ln_gru._launch(lib, joint, w, None, g, beta, h, 1e-3)
        torch.cuda.synchronize()
        if i < 2:  # warm-up
            continue
        rc = lib.ln_gru_phases(ctypes.addressof(stamps), plan.ctas)
        if rc != 0:
            raise RuntimeError(f"reading phase stamps failed: {lib.ln_gru_error_string(rc).decode()}")
        n = len(PHASES) + 1
        for p, name in enumerate(PHASES):
            per_phase[name].append(statistics.median(
                stamps[c * n + p + 1] - stamps[c * n + p] for c in range(plan.ctas)))
    return {name: statistics.median(v) for name, v in per_phase.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ln_gru_phases: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    rows = [(shape, dtype, measure(*shape, dtype, args.reps))
            for shape in SHAPES for dtype in (torch.float32, torch.bfloat16)]
    mhz = _sm_mhz()
    print(f"[phases] {card}; SM clock {mhz:.0f} MHz; median over CTAs and {args.reps} launches, us")
    for (hidden, in_dim, batch), dtype, cycles in rows:
        us = {name: c / mhz for name, c in cycles.items()}
        print(f"[phases] B={batch:<4d} K={hidden + in_dim:<5d} H={hidden:<5d} {str(dtype)[6:]:<8s} "
              + " ".join(f"{name}={v:.2f}" for name, v in us.items()) + f" total={sum(us.values()):.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
