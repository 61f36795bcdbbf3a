"""Inspect an exported offline-RL dataset: shard table, episode-length

The port's counterpart of ``tools/dataset_report.py``: the same arguments and,
from the same run, the same output; it imports neither torch nor JAX, so it
reads a run wherever the run's files are.
histogram and reward summary.

Reads only manifests + the transition keys it needs (never whole pixel
shards), so it is safe on datasets far bigger than RAM:

    python -m sheeprl_tpu_torch.tools.dataset_report <dataset dir>
    python -m sheeprl_tpu_torch.tools.dataset_report <dataset dir> --deep       # re-digest every shard
    python -m sheeprl_tpu_torch.tools.dataset_report <dataset dir> --no-episodes

Shows per-shard steps/bytes/digest status (torn or corrupt shards are listed
with their skip reason, exactly what the offline trainer would journal as
``dataset_shard_skipped``), the per-run metadata ``sheeprl-export`` recorded
from the source journal (reward mean/min/max, run identity), and — when the
dataset stores done flags — an episode-length histogram computed from the
data itself.  See ``howto/offline_rl.md``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.data.datasets import (
    OfflineDataset,
    discover_shards,
    read_dataset_meta,
)
from sheeprl_tpu_torch.diagnostics.report import format_bytes


def shard_table(root: str, deep: bool) -> List[str]:
    good, skipped = discover_shards(root, deep=deep)
    lines = [f"{'shard':<36s} {'stream':>6s} {'steps':>12s} {'bytes':>10s}  status"]
    for entry in good:
        lines.append(
            f"{os.path.basename(entry['path']):<36s} {entry['stream']:>6d} "
            f"{entry['start']:>5d}..{entry['stop']:<6d} {format_bytes(entry['bytes']):>10s}  "
            + ("verified" if deep else "verified (shallow)")
        )
    for skip in skipped:
        lines.append(f"{os.path.basename(skip['path']):<36s} {'-':>6s} {'-':>12s} {'-':>10s}  !! {skip['reason']}")
    return lines


def episode_histogram(ds: OfflineDataset, bins: int = 8) -> List[str]:
    done_keys = [k for k in ("terminated", "truncated") if k in ds.key_specs]
    if not done_keys:
        return ["episodes   (dataset stores no done flags)"]
    lengths: List[int] = []
    open_len = 0
    for seg in ds.segments:
        rows = ds.gather_window(seg.stream, seg.start, seg.rows, keys=done_keys)
        done = np.zeros(seg.rows, dtype=bool)
        for k in done_keys:
            done |= np.asarray(rows[k]).reshape(seg.rows, -1).any(axis=-1)
        open_len = 0
        for flag in done:
            open_len += 1
            if flag:
                lengths.append(open_len)
                open_len = 0
    if not lengths:
        return [f"episodes   none closed ({ds.total_rows} steps, all in-flight)"]
    arr = np.asarray(lengths)
    lines = [
        f"episodes   {len(arr)} closed · len mean {arr.mean():.1f} · "
        f"min {arr.min()} · max {arr.max()}"
    ]
    counts, edges = np.histogram(arr, bins=min(bins, max(1, int(arr.max() - arr.min() + 1))))
    peak = max(1, int(counts.max()))
    for count, lo, hi in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * max(1 if count else 0, round(24 * count / peak))
        lines.append(f"  {lo:7.0f}..{hi:<7.0f} {count:>6d} {bar}")
    return lines


def reward_summary(ds: OfflineDataset, meta: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    journal = (meta.get("meta") or {}).get("journal") or {}
    if journal.get("reward_mean") is not None:
        lines.append(
            f"journal    reward mean {journal['reward_mean']} "
            f"[{journal.get('reward_min')}, {journal.get('reward_max')}] over "
            f"{journal.get('episodes_logged')} logged episodes (source run)"
        )
    if "rewards" in ds.key_specs:
        total = 0.0
        count = 0
        lo, hi = np.inf, -np.inf
        for seg in ds.segments:
            rows = np.asarray(ds.gather_window(seg.stream, seg.start, seg.rows, keys=("rewards",))["rewards"])
            total += float(rows.sum())
            count += rows.size
            if rows.size:
                lo = min(lo, float(rows.min()))
                hi = max(hi, float(rows.max()))
        if count:
            lines.append(
                f"rewards    per-step mean {total / count:.6g} · min {lo:.6g} · max {hi:.6g} "
                f"({count} stored rewards)"
            )
    return lines or ["rewards    (no reward record)"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset", help="dataset directory (sheeprl-export output)")
    parser.add_argument("--deep", action="store_true", help="re-digest every shard (slow, exact)")
    parser.add_argument("--no-episodes", action="store_true", help="skip the episode histogram")
    args = parser.parse_args(argv)

    meta = read_dataset_meta(args.dataset) or {}
    info = meta.get("meta") or {}
    print(f"dataset: {args.dataset}")
    if info:
        bits = [str(info.get(k)) for k in ("algo", "env_id") if info.get(k)]
        extra = f"  seed={info.get('seed')}" if info.get("seed") is not None else ""
        src = f"  source={info.get('source')}" if info.get("source") else ""
        print(f"run      {' on '.join(bits) or '?'}{extra}{src}")
    for line in shard_table(args.dataset, deep=args.deep):
        print(line)
    try:
        ds = OfflineDataset(args.dataset, deep_verify=args.deep)
    except FileNotFoundError as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    print(
        f"totals     {ds.total_rows} steps · {len(ds.streams)} stream(s) · "
        f"{ds.n_shards} shard(s) · {format_bytes(ds.total_bytes)} · keys: {', '.join(sorted(ds.keys))}"
    )
    if not args.no_episodes:
        for line in episode_histogram(ds):
            print(line)
    for line in reward_summary(ds, meta):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
