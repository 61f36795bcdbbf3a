"""Statistics of a recovered-rewards CSV (counterpart of
``sheeprl_tpu/tools/analyze_rewards.py``; csv and numpy only):
``python -m sheeprl_tpu_torch.tools.analyze_rewards <csv>``."""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def analyze(csv_path: str) -> dict:
    """Summarize a rewards CSV; returns the stats it prints (for tests)."""
    with open(csv_path, newline="") as fp:
        rows = list(csv.DictReader(fp))
    print(f"Reward Data Analysis: {csv_path}")
    print("=" * 60)
    print(f"Total data points: {len(rows)}")
    if not rows:
        return {"count": 0}
    columns = list(rows[0].keys())
    print(f"Columns: {columns}")
    stats: dict = {"count": len(rows), "columns": columns}

    value_col = "reward" if "reward" in columns else ("value" if "value" in columns else None)
    if value_col is None:
        return stats
    values = np.array([float(r[value_col]) for r in rows], np.float64)
    stats.update(
        mean=float(values.mean()),
        std=float(values.std()),
        min=float(values.min()),
        max=float(values.max()),
        total=float(values.sum()),
    )
    print(f"\n{value_col.capitalize()} statistics:")
    print(f"  mean={stats['mean']:.4f}  std={stats['std']:.4f}")
    print(f"  min={stats['min']:.4f}  max={stats['max']:.4f}  sum={stats['total']:.4f}")

    nonzero = values[values != 0]
    stats["nonzero_count"] = int(nonzero.size)
    if nonzero.size:
        print(f"\nNon-zero ({nonzero.size} points): mean={nonzero.mean():.4f} sum={nonzero.sum():.4f}")

    group_col = "origin" if "origin" in columns else ("metric" if "metric" in columns else None)
    if group_col:
        print(f"\nPer-{group_col} breakdown:")
        groups: dict = {}
        for r, v in zip(rows, values):
            groups.setdefault(r[group_col], []).append(v)
        stats["groups"] = {}
        for name, vs in sorted(groups.items()):
            arr = np.array(vs)
            nz = arr[arr != 0]
            stats["groups"][name] = {"count": int(arr.size), "nonzero": int(nz.size)}
            line = f"  {name}: {arr.size} points, {nz.size} non-zero"
            if nz.size:
                line += f" (mean {nz.mean():.4f}, sum {nz.sum():.4f})"
            print(line)
    return stats


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Analyze recovered reward CSV files")
    parser.add_argument("csv_file")
    args = parser.parse_args(argv)
    if not Path(args.csv_file).exists():
        raise FileNotFoundError(args.csv_file)
    analyze(args.csv_file)


if __name__ == "__main__":
    main()
