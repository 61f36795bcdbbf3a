"""Run health and observability (counterpart of ``sheeprl_tpu/diagnostics/``).

Seven pillars behind one facade, :class:`Diagnostics`, with the JAX
package's hook names and journal format:

* :mod:`.journal`: the crash-safe JSONL run journal;
* :mod:`.sentinel`: the finiteness guard of the gradient step (``warn`` /
  ``skip_update`` / ``halt``) and the host-side divergence detector;
* :mod:`.tracing`: Chrome-trace spans of the loop's phases;
* :mod:`.telemetry`: the input-signature watchdog, FLOPs from
  ``FlopCounterMode``, MFU against the card's peak and phase accounting,
  and (opt-in) the ``/metrics`` endpoint of :mod:`.metrics_server`;
* :mod:`.memory`: device-memory gauges, the sync guard
  (``torch.cuda.set_sync_debug_mode``) and OOM forensics;
* :mod:`.goodput`: the run-state machine and the stall watchdog;
* :mod:`.health`: gradient, update and parameter statistics of the step and
  the anomaly detectors;

and, from ``sheeprl_tpu_torch/resilience/``, the async manifest-verified
checkpoint writer and graceful preemption.  ``cli.run_algorithm`` builds the
facade and attaches it to the runtime; the loop opens it through
``utils.utils.get_diagnostics`` once its log dir exists, and the logger
proxy (``utils/logger.py``) journals every aggregated metric interval with
the ``Telemetry/*`` gauges merged in.  Every hook is a no-op until opened,
and with ``diagnostics.enabled=False``.
"""

from __future__ import annotations

from typing import Any

__all__ = ["Diagnostics", "SentinelHalt", "build_diagnostics", "config_hash", "health_spec", "run_id_of"]

#: where each re-exported name lives; imported at first use, so that the
#: torch-free readers (``journal``, ``goodput``, ``report``) import without
#: the facade and its torch pillars
_LAZY = {"Diagnostics": "facade", "build_diagnostics": "facade", "config_hash": "facade", "run_id_of": "facade",
         "SentinelHalt": "sentinel", "health_spec": "health"}


def __getattr__(name: str) -> Any:
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
