"""Reward-log recovery (counterpart of ``sheeprl_tpu/tools/recover_rewards.py``):
pull reward traces out of past runs from whatever survived, TensorBoard
event files or the memory-mapped replay buffers, and write them to CSV for
analysis.  The ``tensorboard`` package's event reader and the csv module
suffice; the memmap reader follows the buffer layout both packages write
(``memmap_buffer[/rank_0]/env_*/rewards.memmap``, raw float32).

Usage:
    python -m sheeprl_tpu_torch.tools.recover_rewards --list-runs
    python -m sheeprl_tpu_torch.tools.recover_rewards --run-path logs/runs/<algo>/<env>/<run> \
        [--format all|tensorboard|memmap] [--output-dir recovered]
"""

from __future__ import annotations

import argparse
import csv
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

REWARD_TAGS = ("reward", "rew_avg", "episode")


def list_runs(logs_dir: str = "logs/runs") -> List[Dict[str, Any]]:
    """Enumerate run directories and which recovery formats each offers."""
    root = Path(logs_dir)
    if not root.exists():
        raise FileNotFoundError(f"Logs directory not found: {logs_dir}")
    runs = []
    # layout: logs/runs/<algo>/<env_id>/<run_name>/version_*
    for run_dir in sorted(p for p in root.glob("*/*/*") if p.is_dir()):
        formats = []
        # events live at the run root (this repo's TensorBoardLogger) or
        # under version_* (upstream sheeprl's Lightning layout): accept both
        if any(run_dir.glob("events.out.tfevents.*")) or any(
            run_dir.glob("version_*/events.out.tfevents.*")
        ):
            formats.append("tensorboard")
        if any(run_dir.glob("version_*/memmap_buffer")):
            formats.append("memmap")
        if formats:
            algo, env, name = run_dir.parts[-3:]
            runs.append(
                {"algorithm": algo, "environment": env, "run_name": name, "path": str(run_dir), "formats": formats}
            )
    return runs


def read_tensorboard_rewards(run_path: str) -> List[Dict[str, Any]]:
    """Reward-tagged scalars from every event file under ``version_*``."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError:  # tensorboard is optional
        print("tensorboard package unavailable; skipping event-file recovery")
        return []
    rows: List[Dict[str, Any]] = []
    event_dirs = [Path(run_path)] + sorted(Path(run_path).glob("version_*"))
    for version_dir in event_dirs:
        if not any(version_dir.glob("events.out.tfevents.*")):
            continue
        acc = EventAccumulator(str(version_dir), size_guidance={"scalars": 0})
        try:
            acc.Reload()
        except Exception as err:  # noqa: BLE001 - recovery keeps going on bad files
            print(f"Could not read events under {version_dir}: {err}")
            continue
        for tag in acc.Tags().get("scalars", []):
            if not any(t in tag.lower() for t in REWARD_TAGS):
                continue
            for ev in acc.Scalars(tag):
                rows.append(
                    {
                        "step": ev.step,
                        "wall_time": ev.wall_time,
                        "metric": tag,
                        "value": ev.value,
                        "version": version_dir.name,
                    }
                )
    return rows


def read_memmap_rewards(run_path: str) -> List[Dict[str, Any]]:
    """Raw per-step rewards straight out of the replay buffers on disk."""
    rows: List[Dict[str, Any]] = []
    for reward_file in sorted(Path(run_path).glob("version_*/memmap_buffer/**/rewards.memmap")):
        try:
            values = np.memmap(reward_file, dtype=np.float32, mode="r")
        except (OSError, ValueError) as err:
            print(f"Could not read {reward_file}: {err}")
            continue
        origin = str(reward_file.parent.relative_to(run_path))
        for i, v in enumerate(np.asarray(values).reshape(-1)):
            rows.append({"step": i, "origin": origin, "reward": float(v)})
    return rows


def recover(run_path: str, format_type: str = "all") -> Dict[str, List[Dict[str, Any]]]:
    out: Dict[str, List[Dict[str, Any]]] = {}
    if format_type in ("all", "tensorboard"):
        rows = read_tensorboard_rewards(run_path)
        if rows:
            out["tensorboard"] = rows
    if format_type in ("all", "memmap"):
        rows = read_memmap_rewards(run_path)
        if rows:
            out["memmap"] = rows
    return out


def save_csv(recovered: Dict[str, List[Dict[str, Any]]], output_dir: str) -> List[str]:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for fmt, rows in recovered.items():
        path = out / f"rewards_{fmt}.csv"
        with open(path, "w", newline="") as fp:
            writer = csv.DictWriter(fp, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
        written.append(str(path))
        print(f"Saved {len(rows)} {fmt} rows to {path}")
    return written


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Recover reward logs from past runs")
    parser.add_argument("--logs-dir", default="logs/runs")
    parser.add_argument("--list-runs", action="store_true")
    parser.add_argument("--run-path", default=None)
    parser.add_argument("--format", default="all", choices=["all", "tensorboard", "memmap"])
    parser.add_argument("--output-dir", default="recovered_rewards")
    args = parser.parse_args(argv)

    if args.list_runs:
        runs = list_runs(args.logs_dir)
        if not runs:
            print("No recoverable runs found.")
            return
        for r in runs:
            print(f"{r['algorithm']}/{r['environment']}/{r['run_name']}  [{', '.join(r['formats'])}]")
            print(f"    {r['path']}")
        return

    if not args.run_path:
        parser.error("--run-path is required unless --list-runs is given")
    if not os.path.isdir(args.run_path):
        raise FileNotFoundError(f"Run directory not found: {args.run_path}")
    recovered = recover(args.run_path, args.format)
    if not recovered:
        print("No reward data recovered.")
        return
    save_csv(recovered, args.output_dir)


if __name__ == "__main__":
    main()
