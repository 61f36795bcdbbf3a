"""The time of one SAC, DroQ or SAC-AE gradient step on a CUDA card, and
where its device time goes.

    python -m sheeprl_tpu_torch.algos.sac.step_profile [--steps 10] [--diagnostics] [exp=sac|droq|sac_ae] [dotted.key=value ...]

Builds the agent and optimizers of ``exp`` (``sac`` by default) at its own
widths from a seed on the card, as the loop's family builds them (hidden
256, two critics, batch 256 on the dummy env's 10-dim ``state``; SAC-AE:
64x64 ``rgb`` with a 3-frame stack, 9 channels, plus ``state``, features
64, 32-channel convolutions, actor and critics 1,024 wide, batch 128), and
times single gradient steps on a synthetic batch with their noise drawn on
the card: SAC's critic, target, actor and alpha updates (with
``--diagnostics`` the health stats too, as the default diagnostics run it),
DroQ's the same on two batches with dropout masks (SAC's and DroQ's with
the conservative Q penalty under ``algo.offline.cql_alpha > 0``, its
proposals drawn on the card), SAC-AE's five updates behind their gates,
the counter running on (an average over the gates' phases).  The timing and profiling are DreamerV3's
(``algos/dreamer_v3/step_profile.py::time_gradient_steps``); the FLOPs of a
step are counted with ``FlopCounterMode`` (SAC-AE's averaged over one step
of each gate phase).  No CPU fallback.  ``chip_smoke.py`` calls
:func:`profiled_update` and the same timer.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

#: the env's spaces the profile builds on (the dummy env's, the action
#: space bounded as a SAC-family run on it needs)
STATE_DIM, ACT_DIM, FRAMES, SCREEN = 10, 2, 3, 64


def _spaces(cfg):
    from sheeprl_tpu_torch.envs import spaces

    obs = {"state": spaces.Box(-20, 20, (STATE_DIM,), "float32")}
    if cfg.algo.cnn_keys.encoder:
        obs["rgb"] = spaces.Box(0, 255, (FRAMES, 3, SCREEN, SCREEN), "uint8")
    return spaces.Dict(obs), spaces.Box(-1.0, 1.0, (ACT_DIM,), "float32")


def profiled_update(overrides: Sequence[str], device: torch.device | str,
                    diagnostics: bool = False) -> Tuple[Callable, Dict[str, Any], Dict[str, Any]]:
    """``(step, batch, info)``: one gradient step of the family ``exp=``
    in ``overrides`` names, as a ``(moments, batch, tau, generator) ->
    (moments, metrics)`` step for ``time_gradient_steps`` (``moments``
    unused), a synthetic batch of one gradient step on the card, and
    ``info`` (the algorithm, the batch size, the parameter count, the FLOPs
    of a step)."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics.telemetry import count_flops

    exp = next((o.split("=", 1)[1] for o in overrides if o.startswith("exp=")), "sac")
    rest = [o for o in overrides if not o.startswith("exp=")]
    base = [f"exp={exp}", "env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "seed=5",
            "algo.mlp_keys.encoder=[state]", *([] if diagnostics else ["diagnostics=off"])]
    if exp == "sac_ae":
        base += ["algo.cnn_keys.encoder=[rgb]", f"env.frame_stack={FRAMES}", f"env.screen_size={SCREEN}"]
    cfg = compose(base + rest)
    obs_space, action_space = _spaces(cfg)
    if exp == "sac":
        from sheeprl_tpu_torch.algos.sac.sac import SACFamily as Family
    elif exp == "droq":
        from sheeprl_tpu_torch.algos.droq.droq import DroQFamily as Family
    elif exp == "sac_ae":
        from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAEFamily as Family
    else:
        raise ValueError(f"exp={exp}: the profile runs sac, droq or sac_ae")
    family = Family(cfg, obs_space, action_space, None, device).make_update()
    n = int(cfg.algo.per_rank_batch_size)
    gen = torch.Generator(device=device).manual_seed(5)

    def rows(*shape):
        return torch.randn(1, n, *shape, generator=gen, device=device)

    batch: Dict[str, Any] = {"actions": rows(ACT_DIM).clamp(-1, 1), "rewards": rows(1),
                             "terminated": (torch.rand(1, n, 1, generator=gen, device=device) < 0.05).float()}
    if exp == "sac_ae":
        for prefix in ("", "next_"):
            batch[f"{prefix}rgb"] = torch.randint(0, 256, (1, n, FRAMES * 3, SCREEN, SCREEN), generator=gen,
                                                  device=device).float()
            batch[f"{prefix}state"] = rows(STATE_DIM)
    else:
        batch["observations"], batch["next_observations"] = rows(STATE_DIM), rows(STATE_DIM)
    actor_obs = {"observations": rows(STATE_DIM)}

    def one(counter=None):
        if exp == "sac":
            return family.update(batch, torch.randn(1, n, ACT_DIM, generator=gen, device=device),
                                 family.cql_noise(1, n, gen))
        if exp == "droq":
            from sheeprl_tpu_torch.algos.droq.droq import draw_noise

            return family.update(batch, actor_obs, draw_noise(family.agent, 1, n, ACT_DIM, gen, device,
                                                              family.cql_samples))
        noise = {"eps_next": torch.randn(1, n, ACT_DIM, generator=gen, device=device),
                 "eps_actor": torch.randn(1, n, ACT_DIM, generator=gen, device=device),
                 "pixels": {"rgb": torch.rand(batch["rgb"].shape, generator=gen, device=device)}}
        metrics, family.counter = family.update(batch, noise, family.counter if counter is None else counter)
        return metrics

    def step(moments, data, tau, generator):
        return moments, one()

    if exp == "sac_ae":
        flops = sum(count_flops(lambda c=c: one(c))[1] for c in (0, 1)) / 2
    else:
        _, flops = count_flops(one)
    info = {"algo": exp, "batch_size": n, "params": sum(p.numel() for p in family.agent.parameters()),
            "flops": flops, "precision": str(cfg.fabric.get("precision", "32-true"))}
    return step, batch, info


def main(argv=None) -> None:
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import time_gradient_steps
    from sheeprl_tpu_torch.diagnostics.telemetry import resolve_peak_flops
    from sheeprl_tpu_torch.parallel.runtime import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--diagnostics", action="store_true", help="the step with the health stats (SAC)")
    parser.add_argument("overrides", nargs="*", help="exp=sac|droq|sac_ae and dotted config overrides")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    step, batch, info = profiled_update(args.overrides, device, args.diagnostics)
    out = time_gradient_steps(step, None, batch, None, args.steps, warmup=3, profile=True)
    peak = resolve_peak_flops(torch.cuda.get_device_name(0), info["precision"])
    mfu = info["flops"] / (out["step_ms"] / 1e3) / peak if peak else None
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] {info['algo']} gradient step (batch {info['batch_size']}, {info['params']} params, "
          f"{info['flops']:.6g} FLOPs): {out['step_ms']:.3f} ms median stream time, device busy "
          f"{out['busy_ms']:.3f} ms in {out['launches']} launches, idle share {out['idle_share']:.4f}, step MFU "
          f"{mfu}  [{name}]")
    total = sum(v[1] for v in out["kernels"].values())
    for kname, (calls, us) in sorted(out["kernels"].items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[profile] {100 * us / total:6.2f} %  {us / 1e3 / args.steps:8.3f} ms/step  "
              f"{calls // args.steps:5d} calls/step  {kname[:100]}")


if __name__ == "__main__":
    main()
