"""Hyperparameter search harness (counterpart of
``sheeprl_tpu/tools/search.py``): the JAX package's search, whose trials run
in process through the port's ``sheeprl_tpu_torch.cli.run``.

It is self-contained, with its own samplers and schedulers and no Optuna:

- a categorical search space (default: the fork's Phase-1 JEPA grid,
  ``jepa_coef`` x ``jepa_ema`` x ``jepa_mask.erase_frac``);
- ``random``, ``grid``, or ``tpe`` sampling; the TPE sampler is a
  Tree-structured Parzen Estimator over categorical choices: observed trials
  split into good (top ``gamma`` quantile) / bad, each candidate scored by
  ``log l(x) - log g(x)`` with Laplace-smoothed per-key densities, best of
  ``n_candidates`` drawn from ``l`` wins (Bergstra et al. 2011);
- two schedulers: synchronous successive halving (every rung multiplies the
  per-trial budget by ``reduction_factor`` and keeps the top
  ``1/reduction_factor``) and ``asha``, asynchronous successive halving
  (Li et al. 2018): each new trial starts at rung 0 and is promoted rung by
  rung whenever it ranks in the top ``1/reduction_factor`` of its rung's
  results so far;
- each trial runs with ``algo.run_test=True``; the objective is the run's
  final-test cumulative reward, and a trial that raises scores ``-inf``
  (its ``error.txt`` says why) while the study goes on.

Artifacts: ``results.csv``, ``topk.json``, ``best_config.yaml``,
``SUMMARY.md`` under ``--output-dir``.  Run as ``python -m
sheeprl_tpu_torch.tools.search --exp=... --full-steps=N [...]``.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import math
import os
import random
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import yaml

#: the fork's Phase-1 JEPA space
DEFAULT_SPACE: Dict[str, List[Any]] = {
    "algo.jepa_coef": [0.3, 1.0, 3.0],
    "algo.jepa_ema": [0.992, 0.996, 0.999],
    "algo.jepa_mask.erase_frac": [0.4, 0.6],
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Successive-halving hyperparameter search")
    parser.add_argument("--exp", type=str, default="dreamer_v3_jepa", help="exp config to search over")
    parser.add_argument("--env", type=str, default=None, help="env config override (e.g. 'atari', 'dmc')")
    parser.add_argument("--full-steps", type=int, required=True, help="full training steps of Phase 2")
    parser.add_argument("--fidelity-frac", type=float, default=0.15, help="top-rung budget fraction")
    parser.add_argument("--n-trials", type=int, default=20)
    parser.add_argument("--reduction-factor", type=int, default=3, help="halving rate between rungs")
    parser.add_argument("--rungs", type=int, default=2, help="number of successive-halving rungs")
    parser.add_argument("--sampler", type=str, default="tpe", choices=["random", "grid", "tpe"])
    parser.add_argument(
        "--scheduler", type=str, default="asha", choices=["halving", "asha"],
        help="synchronous successive halving vs asynchronous (promotion-based) ASHA",
    )
    parser.add_argument("--tpe-gamma", type=float, default=0.25, help="TPE good-quantile")
    parser.add_argument("--tpe-startup", type=int, default=8, help="random trials before TPE kicks in")
    parser.add_argument("--tpe-candidates", type=int, default=24, help="TPE candidate draws per trial")
    parser.add_argument("--seed0", type=int, default=0, help="base seed; trial i runs with seed0+i")
    parser.add_argument("--output-dir", type=str, default="./runs/phase1")
    parser.add_argument(
        "--space",
        type=str,
        default=None,
        help="JSON dict of {config.key: [choices...]} replacing the default JEPA space",
    )
    parser.add_argument(
        "--override",
        action="append",
        default=[],
        help="extra config overrides applied to every trial (repeatable)",
    )
    args = parser.parse_args(argv)
    if args.full_steps <= 0:
        raise ValueError(f"full_steps must be > 0, got {args.full_steps}")
    if not 0.0 < args.fidelity_frac <= 1.0:
        raise ValueError(f"fidelity_frac must be in (0, 1], got {args.fidelity_frac}")
    if args.n_trials < 1:
        raise ValueError(f"n_trials must be >= 1, got {args.n_trials}")
    if args.reduction_factor < 2:
        raise ValueError(f"reduction_factor must be >= 2, got {args.reduction_factor}")
    return args


def sample_trials(space: Dict[str, List[Any]], n_trials: int, sampler: str, seed: int) -> List[Dict[str, Any]]:
    """Draw ``n_trials`` parameter assignments from a categorical space."""
    keys = sorted(space)
    if sampler == "grid":
        grid = list(itertools.product(*(space[k] for k in keys)))
        rng = random.Random(seed)
        rng.shuffle(grid)
        picks = (grid * math.ceil(n_trials / len(grid)))[:n_trials]
        return [dict(zip(keys, p)) for p in picks]
    rng = random.Random(seed)
    return [{k: rng.choice(space[k]) for k in keys} for _ in range(n_trials)]


class TPESampler:
    """Tree-structured Parzen Estimator over a categorical space.

    ``observations`` are ``(params, value)`` with HIGHER better.  Choices are
    scored by ``log l(x) - log g(x)`` where ``l``/``g`` are Laplace-smoothed
    empirical categoricals of the good/bad split at quantile ``gamma``; the
    candidate maximizing the acquisition among ``n_candidates`` draws from
    ``l`` is proposed.  Until ``n_startup`` observations exist, sampling is
    uniform (Optuna TPESampler's ``n_startup_trials`` semantics)."""

    def __init__(
        self,
        space: Dict[str, List[Any]],
        seed: int = 0,
        gamma: float = 0.25,
        n_startup: int = 8,
        n_candidates: int = 24,
    ):
        if not 0.0 < gamma < 1.0:
            raise ValueError(f"gamma must be in (0, 1), got {gamma}")
        self.space = {k: list(v) for k, v in space.items()}
        self.keys = sorted(space)
        self.rng = random.Random(seed)
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.observations: List[tuple] = []

    def tell(self, params: Dict[str, Any], value: float) -> None:
        if math.isfinite(value):
            self.observations.append((params, value))

    def _smoothed(self, values: List[Any], choices: List[Any]) -> Dict[Any, float]:
        counts = {c: 1.0 for c in choices}  # Laplace prior
        for v in values:
            counts[v] = counts.get(v, 1.0) + 1.0
        total = sum(counts.values())
        return {c: counts[c] / total for c in choices}

    def ask(self) -> Dict[str, Any]:
        # below 2 observations the good/bad split cannot be disjoint: the sole
        # point would land in both sides and self-penalize (its l/g densities
        # cancel), so the candidate scoring degenerates — stay on random
        # sampling until a real split exists, whatever n_startup says
        if len(self.observations) < max(2, self.n_startup):
            return {k: self.rng.choice(self.space[k]) for k in self.keys}
        ranked = sorted(self.observations, key=lambda o: o[1], reverse=True)
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        if len(ranked) > 1:
            # keep good/bad disjoint: with a tiny study n_good can otherwise
            # cover every observation, making the worst one penalize itself
            n_good = min(n_good, len(ranked) - 1)
        good, bad = ranked[:n_good], ranked[n_good:] or ranked[-1:]
        l_dist = {k: self._smoothed([p[k] for p, _ in good], self.space[k]) for k in self.keys}
        g_dist = {k: self._smoothed([p[k] for p, _ in bad], self.space[k]) for k in self.keys}
        best, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand = {
                k: self.rng.choices(self.space[k], weights=[l_dist[k][c] for c in self.space[k]])[0]
                for k in self.keys
            }
            score = sum(math.log(l_dist[k][cand[k]]) - math.log(g_dist[k][cand[k]]) for k in self.keys)
            if score > best_score:
                best, best_score = cand, score
        return best


def run_trial(
    exp: str,
    params: Dict[str, Any],
    steps: int,
    seed: int,
    trial_dir: Path,
    env: Optional[str] = None,
    extra_overrides: Sequence[str] = (),
) -> float:
    """One training run through the port's CLI; returns the final test
    reward (``-inf`` on failure so the rung ranking drops the trial)."""
    from sheeprl_tpu_torch.cli import run

    trial_dir.mkdir(parents=True, exist_ok=True)
    overrides = [f"exp={exp}"]
    if env:
        overrides.append(f"env={env}")
    overrides += [
        f"algo.total_steps={steps}",
        "algo.run_test=True",
        f"seed={seed}",
        f"root_dir={trial_dir}",
        "checkpoint.every=0",
        "checkpoint.save_last=False",
    ]
    overrides += [f"{k}={v}" for k, v in params.items()]
    overrides += list(extra_overrides)
    try:
        reward = run(overrides)["test_reward"]
    except Exception as err:  # noqa: BLE001 - a failed trial must not kill the study
        (trial_dir / "error.txt").write_text(f"{type(err).__name__}: {err}\n")
        return float("-inf")
    return float(reward) if reward is not None else float("-inf")


def _rung_budgets(args: argparse.Namespace) -> List[int]:
    """Budgets grow toward the top fidelity: b_r = top * rf^(r - last)."""
    top_budget = max(1, int(math.ceil(args.full_steps * args.fidelity_frac)))
    return [
        max(1, top_budget // (args.reduction_factor ** (args.rungs - 1 - r))) for r in range(args.rungs)
    ]


def _default_objective(args: argparse.Namespace):
    output_dir = Path(args.output_dir)

    def objective(params: Dict[str, Any], steps: int, seed: int, trial_id: int, rung: int) -> float:
        trial_dir = output_dir / f"trial_{trial_id}" / f"rung_{rung}"
        return run_trial(args.exp, params, steps, seed, trial_dir, args.env, args.override)

    return objective


def _make_sampler(args: argparse.Namespace, space: Dict[str, List[Any]]):
    """An ask/tell sampler.  random/grid pre-draw the whole cohort; tpe
    proposes sequentially from what it has seen."""
    if args.sampler == "tpe":
        return TPESampler(
            space,
            seed=args.seed0,
            gamma=args.tpe_gamma,
            n_startup=args.tpe_startup,
            n_candidates=args.tpe_candidates,
        )

    class _Pre:
        def __init__(self):
            self._draws = iter(sample_trials(space, args.n_trials, args.sampler, args.seed0))

        def ask(self) -> Dict[str, Any]:
            return next(self._draws)

        def tell(self, params: Dict[str, Any], value: float) -> None:
            pass

    return _Pre()


def _record(records, output_dir, trial_id, rung, steps, seed, params, value, tic):
    record = {
        "trial_id": trial_id,
        "rung": rung,
        "steps": steps,
        "seed": seed,
        **params,
        "eval_return": value,
        "wall_time_s": round(time.time() - tic, 2),
        "state": "COMPLETE" if math.isfinite(value) else "FAILED",
    }
    records.append(record)
    trial_dir = output_dir / f"trial_{trial_id}"
    trial_dir.mkdir(parents=True, exist_ok=True)
    with open(trial_dir / "results.json", "w") as fp:
        json.dump(record, fp, indent=2)
    return record


def successive_halving(args: argparse.Namespace, objective=None) -> List[Dict[str, Any]]:
    """Synchronous successive halving; returns per-trial records (all rungs).
    Rung 0 runs sequentially through the sampler's ask/tell loop, so the TPE
    sampler conditions each proposal on every rung-0 result seen so far (the
    cohort barrier means higher rungs complete only after sampling ends)."""
    space = json.loads(args.space) if args.space else dict(DEFAULT_SPACE)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    objective = objective or _default_objective(args)
    budgets = _rung_budgets(args)
    sampler = _make_sampler(args, space)

    records: List[Dict[str, Any]] = []
    survivors = []
    for rung, budget in enumerate(budgets):
        n = args.n_trials if rung == 0 else len(survivors)
        print(f"[search] rung {rung}: {n} trials x {budget} steps")
        scored = []
        for i in range(n):
            if rung == 0:
                t = {"trial_id": i, "seed": args.seed0 + i, "params": sampler.ask()}
            else:
                t = survivors[i]
            tic = time.time()
            value = objective(t["params"], budget, t["seed"], t["trial_id"], rung)
            if rung == 0:
                sampler.tell(t["params"], value)
            _record(records, output_dir, t["trial_id"], rung, budget, t["seed"], t["params"], value, tic)
            scored.append((value, t))
            print(f"[search]   trial {t['trial_id']}: return={value:.4f}")
        scored.sort(key=lambda x: x[0], reverse=True)
        keep = max(1, len(scored) // args.reduction_factor)
        survivors = [t for _, t in scored[:keep]]
        if rung == len(budgets) - 1 or len(survivors) == 1:
            break
    return records


def asha(args: argparse.Namespace, objective=None) -> List[Dict[str, Any]]:
    """Asynchronous successive halving (Li et al. 2018), sequential driver.

    Each trial starts at rung 0; after finishing rung r it is promoted to
    rung r+1 immediately if it ranks in the top ``1/reduction_factor`` of all
    rung-r results observed SO FAR (with at least ``reduction_factor``
    results to rank against).  No rung-cohort barrier: a strong early trial
    reaches the top fidelity while the study is still exploring, and the TPE
    sampler conditions on every completed evaluation."""
    space = json.loads(args.space) if args.space else dict(DEFAULT_SPACE)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    objective = objective or _default_objective(args)
    budgets = _rung_budgets(args)
    eta = args.reduction_factor
    sampler = _make_sampler(args, space)

    records: List[Dict[str, Any]] = []
    rung_values: List[List[float]] = [[] for _ in budgets]
    for i in range(args.n_trials):
        params = sampler.ask()
        seed = args.seed0 + i
        rung = 0
        last_finite = -math.inf
        while True:
            tic = time.time()
            value = objective(params, budgets[rung], seed, i, rung)
            if math.isfinite(value):
                last_finite = value
            _record(records, output_dir, i, rung, budgets[rung], seed, params, value, tic)
            print(f"[search]   trial {i} rung {rung}: return={value:.4f}")
            rung_values[rung].append(value)
            if rung + 1 >= len(budgets) or not math.isfinite(value):
                break
            seen = sorted(rung_values[rung], reverse=True)
            top_k = max(1, len(seen) // eta)
            if len(seen) >= eta and value >= seen[top_k - 1]:
                rung += 1  # promoted: re-run at the next fidelity
            else:
                break
        # the sampler conditions on the trial's HIGHEST-fidelity result (the
        # least blurred view of the config, like Optuna studies that report
        # the final intermediate value of pruned trials)
        sampler.tell(params, last_finite)
    return records


def save_study(records: List[Dict[str, Any]], args: argparse.Namespace) -> None:
    output_dir = Path(args.output_dir)
    fieldnames = sorted({k for r in records for k in r})
    with open(output_dir / "results.csv", "w", newline="") as fp:
        writer = csv.DictWriter(fp, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(records)

    # rank by the best return any rung achieved
    best_by_trial: Dict[int, Dict[str, Any]] = {}
    for r in records:
        cur = best_by_trial.get(r["trial_id"])
        if cur is None or r["eval_return"] > cur["eval_return"]:
            best_by_trial[r["trial_id"]] = r
    ranked = sorted(best_by_trial.values(), key=lambda r: r["eval_return"], reverse=True)
    param_keys = [k for k in ranked[0] if k.startswith("algo.") or k.startswith("env.")] if ranked else []

    top_k = ranked[: min(6, len(ranked))]
    with open(output_dir / "topk.json", "w") as fp:
        json.dump(
            [
                {
                    "rank": i + 1,
                    "trial_id": r["trial_id"],
                    "best_eval_return": r["eval_return"],
                    "params": {k: r[k] for k in param_keys},
                }
                for i, r in enumerate(top_k)
            ],
            fp,
            indent=2,
        )

    if ranked:
        best = ranked[0]
        best_cfg: Dict[str, Any] = {"exp": args.exp, "seed": best["seed"], "best_eval_return": best["eval_return"]}
        for k in param_keys:
            node = best_cfg
            parts = k.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = best[k]
        with open(output_dir / "best_config.yaml", "w") as fp:
            yaml.safe_dump(best_cfg, fp, sort_keys=False)

    with open(output_dir / "SUMMARY.md", "w") as fp:
        fp.write("# Hyperparameter Search Summary\n\n")
        fp.write(f"**Experiment**: {args.exp}\n")
        fp.write(f"**Trials**: {args.n_trials} ({args.sampler} sampling, ")
        fp.write(f"{args.rungs} rungs, reduction factor {args.reduction_factor})\n")
        fp.write(f"**Top-rung budget**: {int(math.ceil(args.full_steps * args.fidelity_frac))} steps\n\n")
        fp.write("| Rank | Trial | Best return | Params |\n|---|---|---|---|\n")
        for i, r in enumerate(top_k):
            params = ", ".join(f"{k.split('.')[-1]}={r[k]}" for k in param_keys)
            fp.write(f"| {i + 1} | {r['trial_id']} | {r['eval_return']:.4f} | {params} |\n")
        if ranked:
            best = ranked[0]
            fp.write("\n## Best command for Phase 2\n\n```bash\nsheeprl exp=" + args.exp)
            for k in param_keys:
                fp.write(f" \\\n  {k}={best[k]}")
            fp.write(f" \\\n  algo.total_steps={args.full_steps}\n```\n")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    records = asha(args) if args.scheduler == "asha" else successive_halving(args)
    save_study(records, args)
    finished = [r for r in records if r["state"] == "COMPLETE"]
    print(f"[search] done: {len(finished)}/{len(records)} rung-runs completed -> {args.output_dir}")


if __name__ == "__main__":
    main()
