"""Preemption-tolerant training (counterpart of ``sheeprl_tpu/resilience/``):
manifest-verified checkpoints and resume selection (:mod:`.manifest`), the
async checkpoint writer (:mod:`.async_writer`), graceful preemption
(:mod:`.preemption`), fault isolation (:mod:`.isolation`), scripted chaos
and its drill (:mod:`.chaos`), and the auto-restart supervisor
(:mod:`.supervisor`), tied to the ``Diagnostics`` facade by
:class:`~.monitor.ResilienceMonitor`.  The multi-process ``coordination``
and ``sharded`` checkpoints wait for ROADMAP's Parallel item.
"""

from __future__ import annotations

from typing import Any

#: where each re-exported name lives; imported at first use, so that the
#: manifest imports without torch
_LAZY = {
    "AsyncCheckpointWriter": "async_writer", "host_snapshot": "async_writer",
    "FAULTS": "chaos", "ChaosMonitor": "chaos", "ChaosTrainerError": "chaos", "parse_schedule": "chaos",
    "IsolationHalt": "isolation", "IsolationMonitor": "isolation",
    "MANIFEST_SUFFIX": "manifest", "newest_verified_checkpoint": "manifest", "read_manifest": "manifest",
    "reap_orphan_tmps": "manifest", "resolve_resume_from": "manifest", "save_verified_checkpoint": "manifest",
    "verify_checkpoint": "manifest", "write_manifest": "manifest",
    "ResilienceMonitor": "monitor", "RESTARTS_ENV_VAR": "monitor",
    "PREEMPTED_EXIT_CODE": "preemption", "PreemptedExit": "preemption", "PreemptionGuard": "preemption",
    "SUPERVISOR_JOURNAL": "supervisor", "backoff_delay": "supervisor", "supervise": "supervisor",
    "supervise_command": "supervisor",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str) -> Any:
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
