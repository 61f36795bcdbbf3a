"""Scripted fault schedules and the chaos drill (counterpart of
``sheeprl_tpu/resilience/chaos.py``).

``diagnostics.resilience.chaos.schedule`` is a list of ``{iter: N, fault:
<name>}`` entries, each firing once at loop iteration N:

* ``nan_grads``: poison every float leaf of the train batch
  (``Diagnostics.maybe_inject_nan``);
* ``trainer_exception``: raise :class:`ChaosTrainerError` at the train
  dispatch boundary (``Diagnostics.maybe_chaos_trainer_fault``, which the
  decoupled loops call: their quarantine rolls the trainer back);
* ``slow_write``: the next checkpoint write sleeps ``chaos.slow_write_s``
  (in the async writer's thread, or on the critical path when saves block);
* ``preempt``: behave as if a preemption signal arrived (the emergency
  snapshot -> ``preempted`` -> exit 75 chain).

Every firing journals ``fault_injection`` with ``kind=<fault>`` and
``source=chaos``.  :func:`run_drill` runs a schedule through the port's CLI
in a child process and checks the recovery invariants: the exit code, the
journal's event chain, the run's end status and a final checkpoint that
verifies.  ``python -m sheeprl_tpu_torch.tools.chaos_drill`` is its command;
without overrides it drills :data:`DEFAULT_OVERRIDES`, a decoupled PPO run
of one player and one trainer.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

#: the faults a schedule entry may name
FAULTS = ("nan_grads", "trainer_exception", "slow_write", "preempt")


class ChaosTrainerError(RuntimeError):
    """Injected trainer failure (fault ``trainer_exception``), raised at the
    train dispatch boundary so the quarantine path absorbs it as it would a
    real failure."""


def parse_schedule(schedule: Any) -> List[Dict[str, Any]]:
    """Validate a chaos schedule (a list of ``{iter, fault}`` mappings) into
    normalized entries; raises ``ValueError`` naming the offending entry."""
    if schedule in (None, ""):
        return []
    if not isinstance(schedule, Sequence) or isinstance(schedule, (str, bytes)):
        raise ValueError(
            f"diagnostics.resilience.chaos.schedule must be a list of {{iter: N, fault: name}} entries, got "
            f"{schedule!r}"
        )
    out: List[Dict[str, Any]] = []
    for entry in schedule:
        if not isinstance(entry, Mapping):
            raise ValueError(f"chaos schedule entry must be a mapping, got {entry!r}")
        fault = entry.get("fault")
        if fault not in FAULTS:
            raise ValueError(f"chaos schedule entry names unknown fault {fault!r}; valid: {list(FAULTS)}")
        raw_iter = entry.get("iter")
        if raw_iter is None or int(raw_iter) < 1:
            raise ValueError(f"chaos schedule entry needs iter >= 1 (1 = first loop iteration), got {entry!r}")
        out.append({"iter": int(raw_iter), "fault": str(fault), "fired": False})
    return out


class ChaosMonitor:
    """The schedule behind ``ResilienceMonitor``: one-shot firings keyed by
    loop iteration, each journaled as ``fault_injection``."""

    def __init__(self, cfg: Optional[Mapping[str, Any]]):
        cfg = cfg or {}
        chaos_cfg = ((cfg.get("diagnostics") or {}).get("resilience") or {}).get("chaos") or {}
        self.schedule = parse_schedule(chaos_cfg.get("schedule"))
        raw_slow = chaos_cfg.get("slow_write_s")
        self.slow_write_s = 2.0 if raw_slow is None else float(raw_slow)
        if self.slow_write_s <= 0:
            raise ValueError(f"diagnostics.resilience.chaos.slow_write_s must be > 0, got {self.slow_write_s}")
        self.enabled = bool(self.schedule)
        self._journal_fn: Optional[Callable[..., None]] = None
        self._opened = False

    def open(self, journal_fn: Optional[Callable[..., None]] = None) -> None:
        if self._opened:
            return
        self._journal_fn = journal_fn
        self._opened = True

    def take(self, iter_num: int, fault: str) -> bool:
        """True when an unfired entry matches ``(iter_num, fault)``: marks it
        fired and journals the injection."""
        if not self._opened or not self.enabled:
            return False
        for entry in self.schedule:
            if entry["fired"] or entry["fault"] != fault or entry["iter"] != int(iter_num):
                continue
            entry["fired"] = True
            if self._journal_fn is not None:
                self._journal_fn("fault_injection", iter_num=int(iter_num), kind=fault, source="chaos")
            return True
        return False


# ---------------------------------------------------------------------------
# the drill

#: the drill's default workload: a tiny decoupled PPO run (one player, one
#: trainer) on the dummy env, the topology the fence and the rollback are
#: about.  The JAX package's list less ``fabric.accelerator=cpu``: the drill
#: is an entry point, so it runs on the card unless the overrides say
#: otherwise (and raises where there is none)
DEFAULT_OVERRIDES = [
    "exp=ppo_decoupled",
    "env=dummy",
    "env.id=discrete_dummy",
    "env.num_envs=2",
    "env.capture_video=False",
    "buffer.memmap=False",
    "metric.log_level=1",
    "metric.log_every=1",
    "fabric.devices=2",
    "algo.rollout_steps=8",
    "algo.per_rank_batch_size=4",
    "algo.update_epochs=1",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.mlp_keys.encoder=[state]",
    "algo.cnn_keys.encoder=[]",
    "algo.run_test=False",
    "algo.total_steps=96",
    "checkpoint.every=16",
    "checkpoint.save_last=True",
]

#: per fault: the exit codes allowed, and the journal event kinds that must
#: follow the injection in this order
_EXPECTED = {
    "nan_grads": ((0,), ("fault_injection", "params_reject", "rollback", "run_end")),
    "trainer_exception": ((0,), ("fault_injection", "rollback", "run_end")),
    "slow_write": ((0,), ("fault_injection", "ckpt_end", "run_end")),
    "preempt": ((75,), ("fault_injection", "preempted", "run_end")),
}

#: the drill's run name; its journal is searched for under ``run_dir_root``
DRILL_RUN_NAME = "chaos_drill"


def _ordered_subsequence(kinds: Sequence[str], expected: Sequence[str]) -> bool:
    it = iter(kinds)
    return all(kind in it for kind in expected)


def drill_argv(schedule: Sequence[Mapping[str, Any]], overrides: Sequence[str]) -> List[str]:
    """The child's argv: ``python -m sheeprl_tpu_torch run`` with the overrides,
    the pinned run name, the schedule and the halting sentinel (the
    rollback chain needs it; harmless for the other faults)."""
    schedule_yaml = "[" + ",".join(f"{{iter: {e['iter']}, fault: {e['fault']}}}" for e in schedule) + "]"
    return [sys.executable, "-m", "sheeprl_tpu_torch", "run", *overrides, f"run_name={DRILL_RUN_NAME}",
            f"diagnostics.resilience.chaos.schedule={schedule_yaml}", "diagnostics.sentinel.enabled=True",
            "diagnostics.sentinel.policy=halt"]


def judge_drill(schedule: Sequence[Mapping[str, Any]], exit_code: int, run_dir_root: str = "logs/runs",
                run_name: str = DRILL_RUN_NAME) -> Dict[str, Any]:
    """The drill's verdict on a finished run: the exit code, each fault's
    event chain, the final staleness after ``nan_grads``, the run's end
    status and the newest checkpoint that verifies."""
    from sheeprl_tpu_torch.diagnostics.journal import find_journal, read_journal
    from sheeprl_tpu_torch.resilience.manifest import newest_verified_checkpoint

    faults = [e["fault"] for e in schedule]
    verdict: Dict[str, Any] = {"schedule": [{k: e[k] for k in ("iter", "fault")} for e in schedule],
                               "exit_code": exit_code, "checks": {}, "ok": True}

    def check(name: str, ok: bool, detail: Any = None) -> None:
        verdict["checks"][name] = {"ok": bool(ok), **({"detail": detail} if detail is not None else {})}
        verdict["ok"] = verdict["ok"] and bool(ok)

    expected_codes = tuple({c for f in faults for c in _EXPECTED[f][0]}) or (0,)
    check("exit_code", exit_code in expected_codes, {"got": exit_code, "want": list(expected_codes)})
    # newest journal of the run name: a second drill in the same tree is
    # judged on its own run
    candidates = []
    for root, _dirs, files in os.walk(run_dir_root):
        if "journal.jsonl" in files and f"/{run_name}/" in (root + "/"):
            found = find_journal(root)
            if found is not None:
                candidates.append(found)
    journal_path = max(candidates, key=os.path.getmtime, default=None)
    if journal_path is None:
        check("journal", False, f"no journal.jsonl for run_name={run_name} under {run_dir_root}")
        return verdict
    events = read_journal(journal_path)
    kinds = [e.get("event") for e in events]
    verdict["journal"] = journal_path
    for fault in faults:
        chain = _EXPECTED[fault][1]
        check(f"chain:{fault}", _ordered_subsequence(kinds, chain), {"want_in_order": list(chain)})
    if "nan_grads" in faults and exit_code == 0:
        # after the rollback, promotions are healthy again: the last metric
        # interval carries staleness 0 (the gauge exists once the gate ran)
        last_metrics = next((e.get("metrics") or {} for e in reversed(events) if e.get("event") == "metrics"), {})
        staleness = last_metrics.get("Telemetry/param_staleness")
        check("healthy_promotions", staleness == 0, {"final_param_staleness": staleness})
    run_end = next((e for e in reversed(events) if e.get("event") == "run_end"), None)
    want_status = "preempted" if "preempt" in faults else "completed"
    check("run_end", run_end is not None and run_end.get("status") == want_status, run_end)
    best, skipped = newest_verified_checkpoint(os.path.dirname(journal_path))
    check("final_checkpoint_verifies", best is not None, {"checkpoint": best, "skipped": skipped})
    return verdict


def run_drill(schedule: List[Dict[str, Any]], overrides: Sequence[str], run_dir_root: str = "logs/runs",
              timeout_s: float = 600.0) -> Dict[str, Any]:
    """Run one schedule through the port's CLI in a child process (in the
    current directory) and judge the recovery invariants."""
    from sheeprl_tpu_torch.resilience.supervisor import child_env

    proc = subprocess.run(drill_argv(schedule, overrides), env=child_env(), timeout=timeout_s,
                          stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return judge_drill(schedule, proc.returncode, run_dir_root)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m sheeprl_tpu_torch.tools.chaos_drill``: run a scripted
    fault schedule through the port's CLI and check the recovery invariants.

    Usage::

        chaos_drill --drill preempt [--iter 2] -- exp=dreamer_v3 env=dummy ...
        chaos_drill --schedule '[{iter: 2, fault: slow_write}, {iter: 4, fault: preempt}]' -- <overrides>

    The workload is the overrides after ``--``, or without them
    :data:`DEFAULT_OVERRIDES` (a decoupled PPO run of one player and one
    trainer, on the card: append ``fabric.accelerator=cpu`` after ``--``
    to the default list to drill it on the CPU).  Exit 0: every invariant
    held; 1: one failed.
    """
    import argparse

    import yaml

    argv = list(sys.argv[1:] if argv is None else argv)
    overrides: List[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, overrides = argv[:split], argv[split + 1:]
    parser = argparse.ArgumentParser(prog="chaos_drill", description=main.__doc__.splitlines()[0])
    parser.add_argument("--drill", choices=FAULTS, help="single-fault shorthand")
    parser.add_argument("--iter", type=int, default=2, help="iteration for --drill (default 2)")
    parser.add_argument("--schedule", help="YAML list of {iter: N, fault: name} entries")
    parser.add_argument("--timeout", type=float, default=600.0, help="drill wall-clock budget (s)")
    args = parser.parse_args(argv)

    if bool(args.drill) == bool(args.schedule):
        parser.error("pass exactly one of --drill or --schedule")
    raw = [{"iter": args.iter, "fault": args.drill}] if args.drill else yaml.safe_load(args.schedule)
    schedule = parse_schedule(raw)
    if not schedule:
        parser.error("empty chaos schedule")
    verdict = run_drill(schedule, overrides or DEFAULT_OVERRIDES, timeout_s=args.timeout)
    print(json.dumps(verdict), flush=True)
    for name, result in verdict["checks"].items():
        mark = "ok " if result["ok"] else "FAIL"
        detail = result.get("detail")
        print(f"  [{mark}] {name}" + (f" — {detail}" if detail is not None and not result["ok"] else ""))
    print("chaos drill: " + ("PASSED" if verdict["ok"] else "FAILED"))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
