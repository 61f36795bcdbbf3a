"""The time of a DreamerV3 gradient step on a CUDA card, and where its
device time goes: the one place that times a gradient step.

    python -m sheeprl_tpu_torch.algos.dreamer_v3.step_profile [--steps 5] [--trace PATH] [--diagnostics] \
        [dotted.key=value ...]

Builds DreamerV3-S (``exp=dreamer_v3 env=dummy``: batch 16 x 64, horizon
15, fp32; the dotted overrides on top, e.g. ``fabric.precision=bf16-mixed
algo.rssm_chunks=4 algo.rssm_chunk_burn_in=2``; ``exp=dreamer_v3_jepa``
among them builds DreamerV3-JEPA and ``exp=p2e_dv3_exploration``
Plan2Explore-DV3's exploration step, each at its own XL widths;
``exp=dreamer_v2``, ``exp=dreamer_v1``, ``exp=p2e_dv2_exploration`` and
``exp=p2e_dv1_exploration`` those families' steps at their presets' widths)
from a seed
on the card, with ``--diagnostics`` as the default diagnostics run it
(health stats in the step, telemetry's instrumentation around it;
:func:`profiled_step`), and calls :func:`time_gradient_steps` with the
profiler on.  That warms up, then times ``--steps`` gradient steps
between CUDA events on the stream (a step is host-bound, so its stream time
is about its wall time), then traces as many more with ``torch.profiler``
(CUDA activities through CUPTI) for the device-busy time (the union of the
kernels' intervals), the top kernels and the share of the LayerNorm-GRU
kernel.  The idle share is ``1 - busy / stream time`` of the untraced
steps: tracing slows a step, so the traced steps' own times are not used.
With ``--trace`` it also writes the Chrome trace.  No CPU fallback: without
a CUDA device it raises.  ``chip_smoke.py`` times its gradient steps, with
diagnostics on and off, through the same functions.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import rssm_scan_spec


def synthetic_batch(cfg, actions_dim: Sequence[int], generator: torch.Generator,
                    device: torch.device | str) -> Dict[str, torch.Tensor]:
    """One replay sample at the run's shapes, staged as the training loop
    stages it (uint8 pixels scaled to [-0.5, 0.5] on the device), with the
    stored states of ``algo.rssm_chunks > 1``."""
    T, B = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size
    n, size = int(sum(actions_dim)), cfg.env.screen_size

    def rand(*shape):
        return torch.rand(shape, device=device, generator=generator)

    rgb = torch.randint(0, 256, (T, B, 3, size, size), device=device, generator=generator).float() / 255.0 - 0.5
    actions = torch.nn.functional.one_hot(torch.randint(0, n, (T, B), device=device, generator=generator), n).float()
    batch = {"rgb": rgb, "actions": actions, "terminated": (rand(T, B, 1) < 0.02).float(),
             "is_first": (rand(T, B, 1) < 0.02).float(), "rewards": torch.randn((T, B, 1), device=device,
                                                                                generator=generator)}
    if rssm_scan_spec(cfg)[0] > 1:
        # the player's stored states: one-hot posteriors, tanh recurrents, a
        # few rows written without one
        wm = cfg.algo.world_model
        stoch, discrete = wm.stochastic_size, wm.discrete_size
        idx = torch.randint(0, discrete, (T, B, stoch), device=device, generator=generator)
        batch["rssm_posterior"] = torch.nn.functional.one_hot(idx, discrete).float().reshape(T, B, stoch * discrete)
        batch["rssm_recurrent"] = torch.tanh(torch.randn((T, B, wm.recurrent_model.recurrent_state_size),
                                                         device=device, generator=generator))
        batch["rssm_valid"] = (rand(T, B, 1) >= 0.05).float()
    return batch


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_kernels(prof) -> List[Tuple[str, float, float]]:
    """``(name, start_us, end_us)``, from the trace's start, of each kernel
    and copy a finished ``torch.profiler.profile`` traced on the card, not
    the annotation ranges (``record_function``, ``Optimizer.step``) that
    the trace mirrors on the device.  Read from the profiler's raw records
    with the filter its event tree applies (``prof.events()``, which took
    seconds a call to build over every host and device event of a few
    traced steps)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    start_ns = results.trace_start_ns()  # integer ns from here: as floats they would lose the microseconds
    kernels = []
    for e in results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.is_hidden_event():
            continue
        name = e.name()
        if not name.startswith("gradient_step_") and "#" not in name:
            kernels.append((name, (e.start_ns() - start_ns) / 1e3, (e.end_ns() - start_ns) / 1e3))
    return kernels


def time_gradient_steps(step: Callable, moments: Any, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                        steps: int, warmup: int = 2, profile: bool = False,
                        trace: Optional[str] = None) -> Dict[str, Any]:
    """Time ``steps`` calls of a ``make_train_step`` step on ``batch``
    after ``warmup`` calls: ``step_ms`` is the median stream time between
    CUDA events around one step (about its wall time: the host issues a
    step slower than the card runs it) and ``steps_per_s`` the rate over
    the wall clock.  With ``profile``, ``steps`` more steps are traced for
    ``busy_ms`` (device-busy time a step), ``idle_share`` (``1 - busy_ms /
    step_ms``) and ``kernels`` (name -> [calls, microseconds] over the
    traced steps); ``trace`` writes their Chrome trace."""
    for _ in range(warmup):
        moments, _ = step(moments, batch, 0.02, generator)
    torch.cuda.synchronize()
    stream_ms, wall = [], time.perf_counter()
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        moments, _ = step(moments, batch, 0.02, generator)
        end.record()
        torch.cuda.synchronize()
        stream_ms.append(start.elapsed_time(end))
    wall = time.perf_counter() - wall
    result: Dict[str, Any] = {"step_ms": statistics.median(stream_ms), "stream_ms": stream_ms,
                              "steps_per_s": steps / wall, "steps": steps}
    if not profile:
        return result

    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            with record_function(f"gradient_step_{i}"):
                moments, _ = step(moments, batch, 0.02, generator)
                torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity on this machine")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, start_us, end_us in kernels:
        by_name[name][0] += 1
        by_name[name][1] += end_us - start_us
    busy_ms = _union_us([(start_us, end_us) for _, start_us, end_us in kernels]) / 1e3 / steps
    if trace:
        prof.export_chrome_trace(trace)
    return {**result, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / result["step_ms"],
            "launches": len(kernels) // steps, "kernels": dict(by_name)}


def check_kernel_filter(step: Callable, moments: Any, batch: Dict[str, torch.Tensor],
                        generator: torch.Generator) -> Dict[str, Any]:
    """One more profiled step: the device events :func:`device_kernels`
    reads from the profiler's raw records are the ones its event tree
    (``prof.events()``) gives under the same filter: the same names as
    often and the same device-busy time.  Raises if they differ."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("gradient_step_0"):
            step(moments, batch, 0.02, generator)
            torch.cuda.synchronize()
    raw = device_kernels(prof)
    tree = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and not e.name.startswith("gradient_step_") and "#" not in e.name]
    raw_busy = _union_us([(a, b) for _, a, b in raw]) / 1e3
    tree_busy = _union_us([(e.time_range.start, e.time_range.end) for e in tree]) / 1e3
    names, tree_names = collections.Counter(name for name, _, _ in raw), collections.Counter(e.name for e in tree)
    if names != tree_names or abs(raw_busy - tree_busy) > 1e-6 * tree_busy:
        raise AssertionError(f"raw records: {len(raw)} device events, busy {raw_busy} ms; event tree: {len(tree)}, "
                             f"busy {tree_busy} ms; apart: {(names - tree_names) + (tree_names - names)}")
    return {"events": len(raw), "names": len(names), "busy_ms": raw_busy}


def profiled_step(overrides: Sequence[str], device: torch.device | str, diagnostics: bool = False):
    """``(step, moments, batch, generator)``: a gradient step of the
    DreamerV3 family at the composed config (DreamerV3-S unless
    ``overrides`` say otherwise; the algorithm's own agent and step), its
    Moments and a synthetic batch, from seed 5.  With ``diagnostics`` the
    step is built as ``run`` builds it under the default diagnostics: the
    health stats on, wrapped by telemetry's instrumentation (signature
    watch, FLOP count at its first call); without, as ``diagnostics=off``."""
    import importlib

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics import build_diagnostics
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.parallel.precision import resolve_precision
    from sheeprl_tpu_torch.serving.loader import _actions_dim
    from sheeprl_tpu_torch.utils.registry import find_algorithm

    cfg = compose(["exp=dreamer_v3", "env=dummy", "run_name=step_profile", "seed=5",
                   *([] if diagnostics else ["diagnostics=off"]), *overrides])
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous, _ = _actions_dim(env.action_space)
    # the algorithm's training module: its agent builder and gradient step
    family = importlib.import_module(find_algorithm(cfg.algo.name)["module"])
    agent = family.build_agent(actions_dim, is_continuous, cfg, env.observation_space, None, device)
    for module in agent:  # bf16-true stores the weights in bf16, as the training loop does
        module.to(resolve_precision(cfg.fabric.precision)[0])
    env.close()
    step = build_diagnostics(cfg).instrument("train_step", family.make_train_step(agent, make_optimizers(cfg, agent),
                                                                                  cfg, is_continuous))
    gen = torch.Generator(device=device).manual_seed(5)
    return step, agent.initial_moments(device), synthetic_batch(cfg, actions_dim, gen, device), gen


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--trace", default=None, help="write the Chrome trace here")
    parser.add_argument("--diagnostics", action="store_true",
                        help="the step as the default diagnostics run it (health stats, instrumented)")
    parser.add_argument("--check-filter", action="store_true",
                        help="profile one more step and hold its device events read from the profiler's raw "
                             "records against its event tree's")
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    args = parser.parse_args(argv)

    from sheeprl_tpu_torch.parallel.runtime import resolve_device

    device = resolve_device("cuda")
    step, moments, batch, gen = profiled_step(args.overrides, device, args.diagnostics)
    out = time_gradient_steps(step, moments, batch, gen, args.steps, warmup=3, profile=True, trace=args.trace)

    # the card's name and power limit, beside every number printed
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    steps, by_name = args.steps, out["kernels"]
    total = sum(v[1] for v in by_name.values())
    print(f"[profile] gradient step ({' '.join(args.overrides) or 'DreamerV3-S, fp32'}): {out['step_ms']:.3f} ms median stream time (CUDA events), "
          f"{out['steps_per_s']:.3f} steps/s over {steps} steps; device busy {out['busy_ms']:.3f} ms a step "
          f"(kernel time summed {total / 1e3 / steps:.3f} ms) in {out['launches']} launches, idle share "
          f"{out['idle_share']:.4f}  [{name}]")
    gru = [v for k, v in by_name.items() if "ln_gru" in k]
    gru_us = sum(v[1] for v in gru)
    print(f"[profile] ln_gru kernel: {sum(v[0] for v in gru) // steps} launches a step, "
          f"{gru_us / 1e3 / steps:.4f} ms a step, {100 * gru_us / total:.3f} % of kernel time  [{name}]")
    for kname, (calls, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile] {100 * us / total:6.2f} %  {us / 1e3 / steps:8.3f} ms/step  {calls // steps:6d} "
              f"calls/step  {kname[:110]}")
    if args.check_filter:
        check = check_kernel_filter(step, moments, batch, gen)
        print(f"[profile] kernel filter: one more step's {check['events']} device events ({check['names']} names, "
              f"busy {check['busy_ms']:.3f} ms) from the raw records are the event tree's: the same names as often, "
              f"the same busy time  [{name}]")


if __name__ == "__main__":
    main()
