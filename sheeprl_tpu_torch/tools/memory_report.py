"""Memory post-mortem / footprint report from a run's journal.

The port's counterpart of ``tools/memory_report.py``: the same arguments and,
from the same run, the same output; it imports neither torch nor JAX, so it
reads a run wherever the run's files are.

Renders the memory-telemetry pillar of a run (live or finished, including one
that died of an OOM) without TensorBoard or a live process:

* the ``memory_breakdown`` footprint table — params / optimizer state /
  replay buffers plus the compiled train step's argument/output/activation-
  temp bytes and the device (or live-array) memory state;
* the ``sharding_audit`` per-leaf bytes/sharding table, replicated arrays
  flagged (with the fsdp hint when large leaves stayed replicated);
* the ``fsdp_shard_map`` layout summary when the run trained on a 2-D
  ``("data", "model")`` mesh — per-tree sharded/replicated counts and the
  global vs per-device footprint (howto/sharding.md);
* the HBM gauge timeline (first/peak/last ``Telemetry/hbm_bytes_in_use``);
* every ``host_transfer`` / ``donation_miss`` / ``oom`` event with its
  provenance — the OOM record carries the final memory snapshot taken before
  the process died.

Usage:
    python -m sheeprl_tpu_torch.tools.memory_report logs/runs/ppo/CartPole-v1/<run>/
    python -m sheeprl_tpu_torch.tools.memory_report <run dir or journal.jsonl>
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Sequence

from sheeprl_tpu_torch.diagnostics.journal import find_journal, read_journal
from sheeprl_tpu_torch.diagnostics.report import (
    format_bytes,
    format_event_line,
    format_fsdp_shard_map,
    format_memory_breakdown,
    format_sharding_audit,
    memory_status_lines,
)


def hbm_timeline(events: List[Dict[str, Any]]) -> str:
    samples = [
        (e.get("step"), (e.get("metrics") or {}).get("Telemetry/hbm_bytes_in_use"))
        for e in events
        if e.get("event") == "metrics"
        and isinstance((e.get("metrics") or {}).get("Telemetry/hbm_bytes_in_use"), (int, float))
    ]
    if not samples:
        return "hbm timeline: no Telemetry/hbm_bytes_in_use samples in this journal"
    values = [v for _, v in samples]
    first_step, first = samples[0]
    last_step, last = samples[-1]
    peak = max(values)
    return (
        f"hbm timeline: {len(samples)} samples · first {format_bytes(first)} (step {first_step}) · "
        f"peak {format_bytes(peak)} · last {format_bytes(last)} (step {last_step})"
    )


def report(path: str) -> int:
    journal_path = find_journal(path)
    if journal_path is None:
        print(f"error: no journal.jsonl found under '{path}'", file=sys.stderr)
        return 2
    events = read_journal(journal_path)
    print(f"journal: {journal_path}")
    run_start = next((e for e in events if e.get("event") == "run_start"), None)
    if run_start:
        print(
            "run:     algo={algo} env={env} seed={seed}".format(
                algo=run_start.get("algo", "?"), env=run_start.get("env", "?"), seed=run_start.get("seed", "?")
            )
        )
    run_end = next((e for e in reversed(events) if e.get("event") == "run_end"), None)
    ooms = [e for e in events if e.get("event") == "oom"]
    if run_end is None:
        verdict = "NO run_end event — run was killed or is still going"
        if ooms:
            verdict += " (an `oom` record below explains why)"
        print(f"status:  {verdict}")
    else:
        print(f"status:  {run_end.get('status', 'unknown')} (clean shutdown)")

    for line in memory_status_lines(events):
        print(line)
    print(hbm_timeline(events))

    breakdown = next((e for e in events if e.get("event") == "memory_breakdown"), None)
    if breakdown is not None:
        print()
        print(format_memory_breakdown(breakdown))
    else:
        print("\nno memory_breakdown event (diagnostics.memory disabled, or no instrumented train step ran)")

    audit = next((e for e in events if e.get("event") == "sharding_audit"), None)
    if audit is not None:
        print()
        print(format_sharding_audit(audit))

    shard_map = next((e for e in events if e.get("event") == "fsdp_shard_map"), None)
    if shard_map is not None:
        print()
        print(format_fsdp_shard_map(shard_map))

    movement = [e for e in events if e.get("event") in ("host_transfer", "donation_miss")]
    if movement:
        print("\ndata-movement events:")
        for e in movement:
            print("  " + format_event_line(e))

    for oom in ooms:
        print("\nOOM record:")
        print("  " + format_event_line(oom))
        snapshot = {k: v for k, v in oom.items() if k in ("components", "executables", "device_memory", "live_arrays", "host_rss_bytes", "buffers")}
        if snapshot:
            print(format_memory_breakdown(snapshot))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", help="run dir or journal.jsonl")
    args = parser.parse_args(argv)
    return report(args.path)


if __name__ == "__main__":
    sys.exit(main())
