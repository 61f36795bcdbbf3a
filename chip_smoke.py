#!/usr/bin/env python3
"""Chip smoke for sheeprl_tpu_torch: the quickest proof that the PyTorch port
starts, builds its kernels and serves a policy on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card   — the device's name and power limit (nvidia-smi);
2. build  — compile every hand-written kernel from ``sheeprl_tpu_torch/ops/csrc``
            (one nvcc per source, started together);
3. kernel — the LayerNorm-GRU kernel against its plain PyTorch version on the
            card, fp32 and bf16, at the DreamerV3-S shape (K=1024, H=512;
            B = 1, 8, 37, 128) and the XL shape (K=5120, H=4096; B = 8, 128),
            with device times of the kernel (warm L2, and cold: rotating over
            copies of the inputs that exceed the 50 MB L2), the plain version,
            the projection alone as one torch.matmul (a partial yardstick the
            port never calls) and the bound; then a sweep of the shapes the
            plan cuts differently (ragged H of DV1/DV2, M and L, row chunks,
            a K that needs padding), checked but not timed;
4. slice  — compose ``exp=dreamer_v3 env=dummy``, build DreamerV3-S on the card
            from a seed, write a run directory in the JAX package's checkpoint
            format, start the port's ``serve`` entry point and send /act
            traffic from concurrent sessions over HTTP; every reply must be
            200 with a valid one-hot action, the kernel's launch count must
            equal the number of policy steps the server ran, and one batch
            recomputed through the plain path must agree;
5. the ``kernels`` JSON line, then the result line.

It needs no network, writes only under ``build/`` in the checkout, and stops
every thread it starts.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): device memory rate and, per input type,
# the arithmetic rate the kernel's work runs at (fp32 on the CUDA cores, bf16
# on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# max |kernel - plain| allowed.  fp32: both sum K products in fp32 in
# different orders, ~1e-6 at these shapes; 1e-4 leaves room at K=5120.
# bf16: the same fp32 arithmetic, rounded once to bf16 at the end; a sum-order
# difference can move that rounding by one bf16 step (2^-8 for |h'| < 1).
TOLERANCE = {"float32": 1e-4, "bfloat16": 8e-3}
S_SHAPE = (512, 512)  # (H, D): K = H + D = 1024
XL_SHAPE = (4096, 1024)  # K = 5120
KERNEL_CASES = [(S_SHAPE, b) for b in (1, 8, 37, 128)] + [(XL_SHAPE, b) for b in (8, 128)]
# (H, D, B): DV1 (ragged last CTA), DV2, M, L, row chunks at S and XL, and a K
# whose rows are not 16-byte multiples
SWEEP_CASES = [(200, 400, 5), (600, 400, 37), (1024, 640, 8), (2048, 768, 128), (512, 512, 3000),
               (4096, 1024, 300), (64, 13, 9)]
# rotate over enough copies of (joint, w, h) to exceed the L2 twice over
COLD_BYTES = 100 * 2**20
SESSIONS = 32
REQUESTS_PER_SESSION = 10


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _ptxas_summary(report: str) -> list:
    """One line per compiled kernel instance: its template arguments,
    registers and spill bytes, from nvcc's ``-Xptxas -v`` output."""
    lines, name = [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '.*?kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", line)
        if entry:
            name = f"<{'float' if entry.group(1) == 'f' else 'bf16'},{entry.group(2)},{entry.group(3)}>"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            lines.append([name, None, int(spill.group(1))])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and lines and lines[-1][0] == name and lines[-1][1] is None:
            lines[-1][1] = int(regs.group(1))
    return [f"{n}: {r} registers, {s} bytes spilled" for n, r, s in lines]


def _device_ms(fn, calls: int = 20, reps: int = 11) -> float:
    """Median device time of one call: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events.  Replaying a graph
    keeps host-side launch overhead out of the number.  ``fn`` is one thunk
    (the L2 stays warm, as it does between a policy's steps) or a list of
    thunks called in turn (each on its own copy of the inputs, so that the
    L2 is cold when a copy comes round again)."""
    import torch

    fns = fn if isinstance(fn, list) else [fn]
    calls = max(calls, len(fns))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for f in fns[:3]:
            f()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def measure_ln_gru(batch: int, hidden: int, in_dim: int, dtype_name: str, seed: int = 0, timed: bool = True) -> dict:
    """Kernel vs plain version on the card at one shape: max error (with and
    without a bias) and, if ``timed``, device times.  Launches made here do
    not count."""
    import torch

    from sheeprl_tpu_torch.ops import cuda_build, ln_gru
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference

    dtype = getattr(torch, dtype_name)
    k = hidden + in_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    joint = randn(batch, k).to(dtype)
    w = (randn(3 * hidden, k) / k**0.5).to(dtype)
    g = (1.0 + 0.1 * randn(3 * hidden)).to(dtype)
    beta = (0.1 * randn(3 * hidden)).to(dtype)
    h = torch.tanh(randn(batch, hidden)).to(dtype)
    bias = (0.1 * randn(3 * hidden)).to(dtype)
    errors = []
    for b in (None, bias):
        out = fused_layernorm_gru(joint, w, b, g, beta, h, 1e-3)
        ref = ln_gru_reference(joint, w, b, g, beta, h, 1e-3)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"ln_gru: non-finite output at B={batch} H={hidden} {dtype_name}")
        errors.append((out.float() - ref.float()).abs().max().item())
    err = max(errors)
    if err > TOLERANCE[dtype_name]:
        raise AssertionError(
            f"ln_gru disagrees with its plain version at B={batch} K={k} H={hidden} {dtype_name}: "
            f"max_abs_err {err} > {TOLERANCE[dtype_name]}"
        )
    plan = ln_gru._launch_plan(batch, k, hidden, joint.element_size(),
                               *ln_gru._device_limits(cuda_build.load("ln_gru"), joint.device))
    row = {"B": batch, "K": k, "H": hidden, "dtype": dtype_name, "max_abs_err": err,
           "tolerance": TOLERANCE[dtype_name],
           "plan": f"{len(plan.chunks)} launch(es) x {plan.ctas} CTAs of {plan.units} units, {plan.segs} segments "
                   f"x {plan.stages} stages, {plan.smem_bytes} B shared"}
    if not timed:
        return row
    size = torch.finfo(dtype).bits // 8
    n_bytes = (batch * k + 3 * hidden * k + 2 * 3 * hidden + 2 * batch * hidden) * size
    n_ops = 2 * batch * k * 3 * hidden
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    set_bytes = (joint.numel() + w.numel() + h.numel()) * size
    copies = [(joint.clone(), w.clone(), h.clone()) for _ in range(max(2, -(-COLD_BYTES // set_bytes)))]
    cold = [lambda c=c: fused_layernorm_gru(c[0], c[1], None, g, beta, c[2], 1e-3) for c in copies]
    return {
        **row,
        "ms": _device_ms(lambda: fused_layernorm_gru(joint, w, None, g, beta, h, 1e-3)),
        "ms_cold": _device_ms(cold),
        "plain_ms": _device_ms(lambda: ln_gru_reference(joint, w, None, g, beta, h, 1e-3)),
        "library_ms": _device_ms(lambda: torch.matmul(joint, w.t())),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def _post(url: str, payload: dict, timeout: float = 60.0):
    req = urllib.request.Request(url + "/act", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}")


def run_slice(build_dir: Path, device_name: str = "cuda") -> dict:
    """Phase 4: DreamerV3-S served through the port's entry point."""
    import numpy as np
    import torch
    import yaml

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, gumbel_like
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.interop.flax_params import to_flax
    from sheeprl_tpu_torch.models import blocks
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference
    from sheeprl_tpu_torch.serving.loader import _actions_dim
    from sheeprl_tpu_torch.serving.server import ServeApp
    from sheeprl_tpu_torch.utils.checkpoint import save_state

    cfg = compose(["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "run_name=chip_smoke", "seed=5"])
    wm_cfg = cfg.algo.world_model
    widths = (wm_cfg.recurrent_model.recurrent_state_size, cfg.algo.dense_units, wm_cfg.representation_model.hidden_size,
              cfg.algo.mlp_layers, wm_cfg.encoder.cnn_channels_multiplier, wm_cfg.stochastic_size, wm_cfg.discrete_size)
    if widths != (512, 512, 512, 2, 32, 32, 32):
        raise AssertionError(f"exp=dreamer_v3 did not compose to DreamerV3-S: {widths}")
    env = make_env(cfg, cfg.seed, 0)()
    obs_space, action_space = env.observation_space, env.action_space
    env.close()
    actions_dim, is_continuous, _ = _actions_dim(action_space)
    world_model, actor = build_agent(actions_dim, is_continuous, cfg, obs_space, None, device_name)
    run_dir = build_dir / "run"
    ckpt = run_dir / "checkpoint" / "ckpt_0_0.ckpt"
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "config.yaml", "w") as fp:
        yaml.safe_dump(cfg.as_dict(), fp, sort_keys=False)
    save_state(str(ckpt), to_flax(world_model, actor))
    del world_model, actor

    cfg, ckpt_path, device = cli.serve_config(
        [f"checkpoint_path={ckpt}", "serving.port=0", "serving.batch_buckets=[8,16,32,64,128]",
         "serving.sessions.capacity=64", "serving.max_delay_ms=5.0", f"fabric.accelerator={device_name}"]
    )
    if device.type != device_name:
        raise AssertionError(f"serve selected {device}, expected {device_name}")
    fused_layernorm_gru.launches = 0  # the main path starts here
    app = ServeApp(cfg, ckpt_path, device)
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health.get("status") != "ok" or health.get("algo") != "dreamer_v3":
            raise AssertionError(f"/healthz: {resp.status} {health}")

        replies, latencies, lock = [], [], threading.Lock()

        def client(i: int) -> None:
            rng = np.random.default_rng(1000 + i)
            for j in range(REQUESTS_PER_SESSION):
                rgb = rng.integers(0, 256, size=(3, 64, 64), dtype=np.uint8)
                payload = {"obs": {"rgb": rgb.tolist()}, "session": f"s{i}",
                           "reset": (j == REQUESTS_PER_SESSION // 2 and i % 2 == 0), "greedy": (i + j) % 4 != 0}
                t0 = time.perf_counter()
                status, body = _post(url, payload)
                with lock:
                    latencies.append((time.perf_counter() - t0) * 1e3)
                    replies.append((status, body))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SESSIONS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish within 600 s")
        launches = fused_layernorm_gru.launches  # the main path ends here

        bad = [(s, b) for s, b in replies if s != 200]
        if bad or len(replies) != SESSIONS * REQUESTS_PER_SESSION:
            raise AssertionError(f"{len(bad)} of {len(replies)} replies were not 200; first: {bad[:1]}")
        n_actions = int(sum(actions_dim))
        for _, body in replies:
            a = np.asarray(body["action"], dtype=np.float64)
            if a.shape != (n_actions,) or not np.all(np.isfinite(a)):
                raise AssertionError(f"bad action {body['action']}")
            if np.abs(a - np.round(a)).max() > 1e-5 or round(float(a.sum())) != 1 or a.round().max() != 1:
                raise AssertionError(f"action is not one-hot: {body['action']}")
        stats = app.service.batcher.stats()
        steps = stats["dispatches_total"] + app.service.warmup_steps
        if launches != steps or launches == 0:
            raise AssertionError(
                f"ln_gru launched {launches} times for {stats['dispatches_total']} dispatches "
                f"+ {app.service.warmup_steps} warm-up steps"
            )

        # one batch of live sessions recomputed through the plain path on the
        # card, from the same slab state with the same noise
        service, handle = app.service, app.handle
        slots = sorted(service.sessions._lru.values())[:8]
        idx = torch.tensor(slots, dtype=torch.int64, device=device)
        state = {k: v[idx].clone() for k, v in service.sessions.slab.items()}
        rng = np.random.default_rng(7)
        obs = {"rgb": torch.from_numpy(rng.integers(0, 256, size=(len(slots), 3, 64, 64), dtype=np.uint8)).to(device)}
        is_first = torch.tensor([[float(i % 3 == 0)] for i in range(len(slots))], device=device)
        stoch, disc = wm_cfg.stochastic_size, wm_cfg.discrete_size
        noise = {"representation": gumbel_like(
            torch.empty(len(slots), stoch, disc, device=device), torch.Generator(device=device).manual_seed(3))}
        step = handle.make_state_step(True)
        kernel_out = step(handle.params, state, obs, is_first, None, noise)
        with mock.patch.object(blocks, "fused_layernorm_gru", ln_gru_reference):
            plain_out = step(handle.params, state, obs, is_first, None, noise)
        rec_err = (kernel_out[1]["recurrent"] - plain_out[1]["recurrent"]).abs().max().item()
        if rec_err > TOLERANCE["float32"]:
            raise AssertionError(f"recurrent state: kernel vs plain path max_abs_err {rec_err}")
        if not torch.equal(kernel_out[1]["stochastic"].round(), plain_out[1]["stochastic"].round()):
            raise AssertionError("posterior sample differs between the kernel and the plain path")
        if not torch.equal(kernel_out[0].round(), plain_out[0].round()):
            raise AssertionError("actions differ between the kernel and the plain path")
    finally:
        app.close()

    lat = sorted(latencies)
    widths_hist = stats["width_hist"]
    return {
        "requests": len(replies),
        "sessions": SESSIONS,
        "dispatches": stats["dispatches_total"],
        "warmup_steps": app.service.warmup_steps,
        "ln_gru_launches": launches,
        "width_hist": widths_hist,
        "main_width": int(max(widths_hist, key=widths_hist.get)),
        "requests_per_s": len(replies) / wall_s,
        "latency_p50_ms": lat[len(lat) // 2],
        "latency_p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))],
        "plain_recompute_recurrent_max_abs_err": rec_err,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from sheeprl_tpu_torch.ops import cuda_build

    build_dir = ROOT / "build" / "chip_smoke"
    build_dir.mkdir(parents=True, exist_ok=True)
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; nvidia-smi name,power.limit:", flush=True)
    print(card, flush=True)

    t0 = time.monotonic()
    report = cuda_build.build()
    print(f"[build] {len(report)} kernel(s) in {time.monotonic() - t0:.1f} s", flush=True)
    for name, rep in report.items():
        print(f"[build] {name}: {rep['path']} ({rep['seconds']:.1f} s)", flush=True)
        for line in _ptxas_summary(str(rep["ptxas"])):
            print(f"[build] {name} ptxas {line}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true fp32
    torch.backends.cudnn.allow_tf32 = False
    cases = []
    for (hidden, in_dim), batch in KERNEL_CASES:
        for dtype_name in ("float32", "bfloat16"):
            row = measure_ln_gru(batch, hidden, in_dim, dtype_name)
            cases.append(row)
            print(
                f"[kernel] ln_gru B={batch:<4d} K={row['K']:<5d} H={hidden:<5d} {dtype_name:<8s} "
                f"max_abs_err={row['max_abs_err']:.3g} (tol {row['tolerance']:g})  ms={row['ms']:.5f} "
                f"ms_cold={row['ms_cold']:.5f} plain_ms={row['plain_ms']:.5f} matmul_ms={row['library_ms']:.5f} "
                f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}); {row['plan']}  [{card}]",
                flush=True,
            )
    for hidden, in_dim, batch in SWEEP_CASES:
        for dtype_name in ("float32", "bfloat16"):
            row = measure_ln_gru(batch, hidden, in_dim, dtype_name, seed=1, timed=False)
            print(f"[kernel] ln_gru sweep B={batch:<4d} K={row['K']:<5d} H={hidden:<5d} {dtype_name:<8s} "
                  f"max_abs_err={row['max_abs_err']:.3g} (tol {row['tolerance']:g})", flush=True)

    slice_report = run_slice(build_dir)
    print(
        f"[slice] DreamerV3-S serve: {slice_report['requests']} /act from {slice_report['sessions']} sessions, "
        f"all 200 and one-hot; {slice_report['dispatches']} dispatches + {slice_report['warmup_steps']} warm-up "
        f"steps = {slice_report['ln_gru_launches']} ln_gru launches; widths {slice_report['width_hist']}; "
        f"{slice_report['requests_per_s']:.1f} requests/s, p50 {slice_report['latency_p50_ms']:.2f} ms, "
        f"p99 {slice_report['latency_p99_ms']:.2f} ms; plain-path recompute recurrent max_abs_err "
        f"{slice_report['plain_recompute_recurrent_max_abs_err']:.3g}  [{card}]",
        flush=True,
    )

    # the kernels line reports the shape the main path gave the kernel most
    main = next((c for c in cases if c["B"] == slice_report["main_width"] and c["H"] == 512
                 and c["dtype"] == "float32"), None)
    if main is None:
        main = measure_ln_gru(slice_report["main_width"], *S_SHAPE, "float32")
    kernels = [{
        "name": "ln_gru",
        "route": "cuda",
        "source": "sheeprl_tpu_torch/ops/csrc/ln_gru.cu",
        "replaces": "sheeprl_tpu/ops/pallas_gru.py:64",
        "launches": slice_report["ln_gru_launches"],
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "ms_cold": main["ms_cold"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": {"B": main["B"], "K": main["K"], "H": main["H"], "dtype": main["dtype"]},
        "phase": "kernel+slice",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
