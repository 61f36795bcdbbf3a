"""What a Gumbel draw that the kernel and the plain path split does to
``chip_smoke.py``'s kernel-vs-plain gradient step, measured on the card.

``run_train``'s check trains DreamerV3-S through ``run``, then takes one
gradient step from its checkpoint through the LayerNorm-GRU kernel and
through the plain path with the same batch and noise.  This script repeats
that check (the smoke's seed 9 and draws in the smoke's order, then more
seeds) three ways: with Gumbel draws and the plain path free, which counts
per sampling site the categorical one-hots that the two paths sample
differently, the largest ``top1 - top2`` margin of ``logits + noise`` among
the split states, and the sampler calls they fell in (in call order: the
scan's 64 prior/posterior pairs, then the actor and the 15 imagined priors
interleaved); with the plain path held to the kernel path's samples, as
the smoke holds it (``chip_smoke.held_samples``); and with noise that
decides every draw whatever the logits (``decisive_like``), the other way
to keep the two paths' samples equal.  It reports the step's errors in
each case, as ``run_train`` computes them.

Run on a card from the repo's root::

    python3 chip_gumbel_split.py [--seeds 9,10,11,12,13] [--out chiprun_out/gumbel_split.json]

One JSON line a seed, and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import chip_smoke as cs


def decisive_like(x, gen):
    """Noise shaped like ``x`` that decides every categorical draw whatever
    the logits: 0 at a class drawn uniformly from ``gen``, -1e4 elsewhere."""
    import torch

    idx = torch.randint(0, x.shape[-1], tuple(x.shape[:-1]) + (1,), device=x.device, generator=gen)
    return torch.full(tuple(x.shape), -1e4, device=x.device).scatter_(-1, idx, 0.0)


def step_errors(results) -> dict:
    """``run_train``'s errors of a kernel-vs-plain step."""
    import numpy as np

    (m_kernel, g_kernel, p_kernel, _), (m_plain, g_plain, p_plain, _) = results
    diff = (p_kernel - p_plain).abs()
    return {"metric_rel_err": float(np.max(np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3))),
            "grad_rel_err": max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max()).item()
                                for k in g_plain),
            "param_outlier_share": (diff > cs.STEP_PARAM_ATOL).float().mean().item(),
            "param_max_abs_err": diff.max().item()}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="9,10,11,12,13")
    parser.add_argument("--out", default="chiprun_out/gumbel_split.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_gumbel_split: no CUDA device", file=sys.stderr)
        return 1

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as agent_mod
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.ops import cuda_build
    from sheeprl_tpu_torch.serving.loader import _actions_dim, agent_state_from_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    card = cs._card_line()
    print(card, flush=True)
    cuda_build.build(["ln_gru"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    overrides = cs.TRAIN_OVERRIDES + [f"root_dir={(cs.ROOT / 'build' / 'gumbel_split').resolve()}",
                                      "fabric.accelerator=cuda"]
    cfg = compose(overrides)
    cs._dv3_s_widths(cfg)
    out = cli.run(overrides)
    state = agent_state_from_checkpoint(load_state(out["checkpoints"][-1]))
    env = make_env(cfg, cfg.seed, 0)()
    obs_space, action_space = env.observation_space, env.action_space
    env.close()
    actions_dim, is_continuous, _ = _actions_dim(action_space)
    spaces_ = (actions_dim, is_continuous, obs_space)
    print(f"trained {out['gradient_steps']} gradient steps in {time.monotonic() - t0:.1f} s", flush=True)

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        # run_train's draws from its generator before the batch: the served
        # observations of its greedy check
        torch.randint(0, 256, (3, 3, cfg.env.screen_size, cfg.env.screen_size), device="cuda", generator=gen,
                      dtype=torch.uint8)
        batch = synthetic_batch(cfg, actions_dim, gen, "cuda")
        after_batch = gen.get_state()
        noise = cs._train_noise(cfg, actions_dim, gen)
        row = {"seed": seed}
        for case, force in (("gumbel", False), ("gumbel_plain_held_to_kernel_samples", True)):
            held = cs.held_samples(force)
            errors = step_errors(cs._kernel_vs_plain_step(cfg, state, spaces_, batch, noise, held=held))
            row[case] = {**errors, "samples": held.samples, "split": held.split, "split_margin_max": held.margin,
                         "split_calls": held.split_calls, "calls": held.calls}
        gen.set_state(after_batch)
        with mock.patch.object(agent_mod, "gumbel_like", decisive_like):
            decisive = cs._train_noise(cfg, actions_dim, gen)
        row["decisive"] = step_errors(cs._kernel_vs_plain_step(cfg, state, spaces_, batch, decisive,
                                                               held=cs.held_samples(False)))
        row["tolerance"] = {"metric_rel_err": cs.STEP_METRIC_RTOL, "grad_rel_err": cs.STEP_GRAD_RTOL,
                            "param_outlier_share": cs.STEP_PARAM_OUTLIERS}
        print(json.dumps(row), flush=True)
        rows.append(row)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
