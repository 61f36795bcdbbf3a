"""The time of one PPO minibatch update on a CUDA card, and where its device
time goes.

    python -m sheeprl_tpu_torch.algos.ppo.step_profile [--steps 10] [--diagnostics] [dotted.key=value ...]

Builds the agent of ``exp=ppo_atari`` on the dummy env (NatureCNN on
``rgb`` at 84x84 with a 4-frame stack, 12 input channels; a 512-unit dense
layer; one categorical head) from a seed on the card, and its update with
one epoch of one minibatch of ``algo.per_rank_batch_size`` (256) rows, so
one call is one minibatch update: forward, backward, clipping, one Adam
step (and, with ``--diagnostics``, the health stats, as the default
diagnostics run it).  The timing and profiling are DreamerV3's
(``algos/dreamer_v3/step_profile.py::time_gradient_steps``): the median
stream time between CUDA events, then ``torch.profiler`` for the
device-busy time, the launches and the idle share.  The update's FLOPs are
counted with ``FlopCounterMode`` on its first call.  No CPU fallback.
``chip_smoke.py`` calls :func:`profiled_update` and the same timer.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Any, Callable, Dict, Sequence, Tuple

import torch


def profiled_update(overrides: Sequence[str], device: torch.device | str,
                    diagnostics: bool = False) -> Tuple[Callable, Dict[str, Any], Dict[str, Any]]:
    """``(step, batch, info)``: one minibatch update of ``exp=ppo_atari
    env=dummy`` (the overrides on top) as a ``(moments, batch, tau,
    generator) -> (moments, metrics)`` step for ``time_gradient_steps``, a
    synthetic minibatch, and ``info`` (the batch size, the agent's
    parameter count, the FLOPs of one update)."""
    from sheeprl_tpu_torch.algos.ppo.agent import actions_dim_of, build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_train_step
    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.diagnostics.telemetry import count_flops
    from sheeprl_tpu_torch.envs.env import make_env

    cfg = compose(["exp=ppo_atari", "env=dummy", "env.capture_video=False", "run_name=step_profile", "seed=5",
                   "algo.update_epochs=1", *([] if diagnostics else ["diagnostics=off"]), *overrides])
    env = make_env(cfg, cfg.seed, 0)()
    obs_space = env.observation_space
    actions_dim, is_continuous, _ = actions_dim_of(env.action_space)
    env.close()
    agent = build_agent(actions_dim, is_continuous, cfg, obs_space, None, device)
    optimizer = instantiate(cfg.algo.optimizer)(agent.parameters())
    n = int(cfg.algo.per_rank_batch_size)
    update = make_train_step(agent, optimizer, cfg, 1, n)
    gen = torch.Generator(device=device).manual_seed(5)

    def rows(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    batch: Dict[str, Any] = {
        "obs": {k: torch.randint(0, 256, (n, *obs_space[k].shape), generator=gen, device=device, dtype=torch.uint8)
                .reshape(n, -1, *obs_space[k].shape[-2:]) for k in cfg.algo.cnn_keys.encoder},
        "actions": torch.randint(0, actions_dim[0], (n, 1), generator=gen, device=device).float(),
        "logprobs": rows(n, 1) - 1.0, "values": rows(n, 1), "returns": rows(n, 1), "advantages": rows(n, 1),
    }
    for k in cfg.algo.mlp_keys.encoder:
        batch["obs"][k] = rows(n, *obs_space[k].shape)
    perms = [torch.randperm(n, generator=gen, device=device)]
    coefs = (float(cfg.algo.clip_coef), float(cfg.algo.ent_coef), float(cfg.algo.vf_coef))

    def step(moments, data, tau, generator):
        return moments, update(data, perms, coefs)

    _, flops = count_flops(lambda: update(batch, perms, coefs))
    info = {"batch_size": n, "params": sum(p.numel() for p in agent.parameters()), "flops": flops,
            "obs_shape": {k: tuple(v.shape) for k, v in batch["obs"].items()}}
    return step, batch, info


def main(argv=None) -> None:
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import time_gradient_steps
    from sheeprl_tpu_torch.parallel.runtime import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--diagnostics", action="store_true", help="the update with the health stats")
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    step, batch, info = profiled_update(args.overrides, device, args.diagnostics)
    out = time_gradient_steps(step, None, batch, None, args.steps, warmup=3, profile=True)
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] PPO minibatch update (exp=ppo_atari widths, batch {info['batch_size']}, obs "
          f"{info['obs_shape']}, {info['params']} params, {info['flops']:.6g} FLOPs): {out['step_ms']:.3f} ms "
          f"median stream time, device busy {out['busy_ms']:.3f} ms in {out['launches']} launches, idle share "
          f"{out['idle_share']:.4f}  [{name}]")
    total = sum(v[1] for v in out["kernels"].values())
    for kname, (calls, us) in sorted(out["kernels"].items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[profile] {100 * us / total:6.2f} %  {us / 1e3 / args.steps:8.3f} ms/update  "
              f"{calls // args.steps:5d} calls/update  {kname[:100]}")


if __name__ == "__main__":
    main()
