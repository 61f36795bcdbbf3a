"""The auto-restart supervisor (counterpart of
``sheeprl_tpu/resilience/supervisor.py``): ``python -m
sheeprl_tpu_torch.tools.supervise``.

Runs a training as a child process (``python -m sheeprl_tpu_torch run``) and
owns the loop from a kill to a recovered run:

* a child that exits 0 ends supervision;
* any other exit (a crash, an OOM kill, a SIGKILL from the scheduler, or
  the graceful-preemption code 75) restarts the child with capped
  exponential backoff (a preempted exit respawns at once: its emergency
  snapshot landed and the pool wants the slot back now) within a restart
  budget;
* every restart resumes from the newest checkpoint whose manifest verifies
  (``checkpoint.resume_from=<that file>``), or from scratch when there is
  none yet;
* each restart is journaled to ``<run dir>/supervisor.jsonl`` (``restart``
  events: attempt, exit code, backoff, downtime, resume source), which the
  port's ``tools/goodput_report.py`` reads for the time to recover.

The run name must be pinned for the restarts to land in one run directory:
without ``run_name=...`` the supervisor pins the composed one and says so.
``--kill-after-first-checkpoint`` SIGKILLs the first child as soon as a
verified checkpoint exists, and lets the restart path prove the cycle.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from sheeprl_tpu_torch.resilience.monitor import RESTARTS_ENV_VAR
from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE

SUPERVISOR_JOURNAL = "supervisor.jsonl"

#: environment variables a child of the port does not inherit: the JAX
#: package's platform and compiler settings
_JAX_ENV_PREFIXES = ("JAX_", "XLA_", "TPU_", "LIBTPU")


def backoff_delay(attempt: int, base_s: float, cap_s: float) -> float:
    """Capped exponential: ``base * 2**(attempt-1)``, at most ``cap``."""
    if attempt <= 0:
        return 0.0
    return float(min(cap_s, base_s * (2 ** (attempt - 1))))


def child_env(restarts: Optional[int] = None) -> Dict[str, str]:
    """The environment of a ``python -m sheeprl_tpu_torch`` child: this
    one without the JAX package's settings, this checkout first on
    ``PYTHONPATH`` (the child imports the same port from any directory) and,
    for a supervised child, the restarts so far (``sheeprl_restarts_total``)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(_JAX_ENV_PREFIXES)}
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH", "")
    if pkg_root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = pkg_root + (os.pathsep + existing if existing else "")
    if restarts is not None:
        env[RESTARTS_ENV_VAR] = str(int(restarts))
    return env


def _kill_after_checkpoint(proc: subprocess.Popen, run_dir: str, poll_s: float) -> None:
    """Drill thread: SIGKILL the child as soon as a verified checkpoint
    exists under the run directory (the scheduler's kill without grace)."""
    from sheeprl_tpu_torch.resilience.manifest import newest_verified_checkpoint

    while proc.poll() is None:
        best, _ = newest_verified_checkpoint(run_dir, deep=True)
        if best is not None:
            try:
                proc.send_signal(signal.SIGKILL)
            except OSError:  # the child is already gone
                pass
            return
        time.sleep(poll_s)


def supervise_command(
    argv_builder: Callable[[Optional[str]], List[str]],
    run_dir: str,
    max_restarts: int = 5,
    backoff_base_s: float = 1.0,
    backoff_max_s: float = 60.0,
    kill_after_first_checkpoint: bool = False,
    poll_s: float = 0.5,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> int:
    """The restart loop over any child command: ``argv_builder(resume)``
    gives the argv of each attempt (``resume`` is the newest verified
    checkpoint, or None).  Returns the exit code supervision ends with (0:
    the run completed)."""
    from sheeprl_tpu_torch.diagnostics.journal import RunJournal
    from sheeprl_tpu_torch.resilience.manifest import newest_verified_checkpoint

    os.makedirs(run_dir, exist_ok=True)
    journal = RunJournal(os.path.join(run_dir, SUPERVISOR_JOURNAL))
    restarts = 0
    last_rc: Optional[int] = None
    exit_t: Optional[float] = None
    backoff_s = 0.0
    drill_pending = bool(kill_after_first_checkpoint)
    try:
        while True:
            resume, _skipped = newest_verified_checkpoint(run_dir, deep=True)
            if restarts > 0:
                journal.write("restart", attempt=restarts, rc=last_rc, preempted=last_rc == PREEMPTED_EXIT_CODE,
                              backoff_s=round(backoff_s, 3),
                              down_s=round(time.time() - exit_t, 3) if exit_t is not None else None,
                              resume_from=resume)
                journal.sync()
            proc = subprocess.Popen(argv_builder(resume), env=child_env(restarts))
            if drill_pending:
                drill_pending = False
                threading.Thread(target=_kill_after_checkpoint, args=(proc, run_dir, poll_s),
                                 name="sheeprl-supervise-drill", daemon=True).start()
            try:
                rc = proc.wait()
            except KeyboardInterrupt:
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                raise
            exit_t = time.time()
            if rc == 0:
                return 0
            last_rc = rc
            if restarts >= max_restarts:
                journal.write("restart", attempt=restarts, rc=rc, gave_up=True)
                journal.sync()
                print(f"sheeprl-supervise: restart budget exhausted after {restarts} restart(s); last exit code "
                      f"{rc}", file=sys.stderr)
                return rc
            restarts += 1
            # a preempted child saved its snapshot and freed the slot on
            # purpose: respawn at once; crashes back off
            backoff_s = 0.0 if rc == PREEMPTED_EXIT_CODE else backoff_delay(restarts, backoff_base_s,
                                                                             backoff_max_s)
            print(f"sheeprl-supervise: child exited rc={rc}{' (preempted)' if rc == PREEMPTED_EXIT_CODE else ''}; "
                  f"restart {restarts}/{max_restarts} in {backoff_s:.1f}s", file=sys.stderr)
            if backoff_s > 0:
                sleep_fn(backoff_s)
    finally:
        journal.close()


def supervise(
    overrides: Sequence[str],
    max_restarts: int = 5,
    backoff_base_s: float = 1.0,
    backoff_max_s: float = 60.0,
    kill_after_first_checkpoint: bool = False,
) -> int:
    """Supervise ``python -m sheeprl_tpu_torch run <overrides>``, resuming
    in ``logs/runs/<root_dir>/<run_name>``."""
    from sheeprl_tpu_torch.config import compose

    overrides = list(overrides)
    cfg = compose(overrides)
    if not any(str(o).startswith("run_name=") for o in overrides):
        # the restarts must land in the same run directory
        overrides.append(f"run_name={cfg.run_name}")
        print(f"sheeprl-supervise: run_name not pinned; using '{cfg.run_name}' for every (re)start",
              file=sys.stderr)
    run_dir = os.path.join("logs", "runs", str(cfg.root_dir), str(cfg.run_name))

    def argv_builder(resume: Optional[str]) -> List[str]:
        argv = [sys.executable, "-m", "sheeprl_tpu_torch", "run", *overrides]
        if resume is not None:
            argv.append(f"checkpoint.resume_from={resume}")
        return argv

    return supervise_command(argv_builder, run_dir, max_restarts=max_restarts, backoff_base_s=backoff_base_s,
                             backoff_max_s=backoff_max_s, kill_after_first_checkpoint=kill_after_first_checkpoint)


def main(args: Optional[Sequence[str]] = None) -> Any:
    parser = argparse.ArgumentParser(
        description="Auto-restart supervisor for sheeprl_tpu_torch training runs (resumes from the newest "
                    "verified checkpoint after any non-clean exit).")
    parser.add_argument("--max-restarts", type=int, default=5, help="restart budget (default 5)")
    parser.add_argument("--backoff", type=float, default=1.0, help="base backoff seconds (doubles per restart)")
    parser.add_argument("--backoff-max", type=float, default=60.0, help="backoff cap in seconds")
    parser.add_argument("--kill-after-first-checkpoint", action="store_true",
                        help="drill: SIGKILL the first child once a verified checkpoint exists, then recover "
                             "through the normal restart path")
    parser.add_argument("overrides", nargs=argparse.REMAINDER, help="dotted overrides passed to run")
    ns = parser.parse_args(list(args) if args is not None else None)
    overrides = [o for o in ns.overrides if o != "--"]
    return sys.exit(supervise(overrides, max_restarts=ns.max_restarts, backoff_base_s=ns.backoff,
                              backoff_max_s=ns.backoff_max,
                              kill_after_first_checkpoint=ns.kill_after_first_checkpoint))


if __name__ == "__main__":
    main()
